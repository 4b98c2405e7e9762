"""language_tower_ms: device milliseconds a head group spent in the language tower (GCP-BERT; GDINO: with its feature map),
between CUDA events that the harness's own module hooks record, with no
synchronisation; the mean over the traced run's unprofiled window."""


def read(record):
    spans = record.get("layer_ms", {}).get("language_tower")
    if not spans:
        return None
    return sum(spans) / len(spans)
