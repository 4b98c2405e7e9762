"""gdino_decoder_ms: device milliseconds a head group spent in the GroundingDINO decoder (first layer to the last box head),
between CUDA events that the harness's own module hooks record, with no
synchronisation; the mean over the traced run's unprofiled window."""


def read(record):
    spans = record.get("layer_ms", {}).get("gdino_decoder")
    if not spans:
        return None
    return sum(spans) / len(spans)
