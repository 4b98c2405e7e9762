"""gdino_encoder_ms: device milliseconds a head group spent in the GroundingDINO encoder (first fusion layer to last deformable layer),
between CUDA events that the harness's own module hooks record, with no
synchronisation; the mean over the traced run's unprofiled window."""


def read(record):
    spans = record.get("layer_ms", {}).get("gdino_encoder")
    if not spans:
        return None
    return sum(spans) / len(spans)
