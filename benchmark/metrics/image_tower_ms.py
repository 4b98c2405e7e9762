"""image_tower_ms: device milliseconds a call spent in the image tower (Swin and the FPN, or Swin and the input projections),
between CUDA events that the harness's own module hooks record, with no
synchronisation; the mean over the traced run's unprofiled window."""


def read(record):
    spans = record.get("layer_ms", {}).get("image_tower")
    if not spans:
        return None
    return sum(spans) / len(spans)
