"""eval_mfu: the protocol's flops per image (the configuration file's count,
from the plain reference) times the window's images a second, over the
card's bf16 dense peak, in percent. Read from the traced run's unprofiled
window."""
from benchmark.work import PEAK_BF16_FLOPS


def read(record):
    flops = record["config"].get("flops", {}).get("per_image")
    if not flops or record.get("img_per_s") is None:
        return None
    return 100.0 * flops * record["img_per_s"] / PEAK_BF16_FLOPS
