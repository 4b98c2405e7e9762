"""Multi-bucket LVIS evaluation: the protocol at each padded geometry that
candidate TPU.IMAGE_BUCKETS sets induce on the COCO / LVIS image-size mix,
and the modelled evaluation time of each set (the port of
`tools/perf_bucket_churn.py`).

    python -m mqdet_torch.tools.perf_bucket_churn [--n-images 5000] [--runs 7]
    python -m mqdet_torch.tools.perf_bucket_churn --device cpu --tiny

An image resized by INPUT.MIN_SIZE_TEST 800 / MAX_SIZE_TEST 1333 lands in
one of SIZE_DISTRIBUTION's seven sizes (the JAX tool's table: ~2/3
landscape, ~1/4 portrait, ~5% near-square) and is padded to the smallest
bucket of a set that holds it (`data/transforms.py::pick_bucket`; buckets
are orientation-free). For every geometry any set in BUCKET_SETS uses, on
MQ-GLIP-T as bench.py builds it (`tools.glip_t`, 8 groups x CP 4, seed 0),
it prints one JSON line: `geometry`, `first_call_s` and `protocol_p50_ms`.
`first_call_s` is the counterpart of the JAX tool's `compile_s`: the seconds
of the first protocol call at the geometry, in which the card chooses its
cuDNN / cuBLAS plans and the allocator grows (the port compiles nothing per
shape: its kernels are built once, at first use); a geometry the process
already ran reads warm. The p50 is over RUNS timed calls, measured once
per pixel count (a geometry and its transpose do the same work).

Then per bucket set, by the JAX tool's arithmetic, one JSON line, cheapest
first: `bucket_set`, `geometries_compiled` (the geometries it uses),
`first_call_total_s` (their first calls; the JAX tool's
`compile_total_s`), `avg_s_per_image` (the distribution's mean of its
bucket's p50), `avg_padding_waste_pct` (padded pixels over the image's),
`total_eval_s_at_N` (first calls + N images x the mean) and `n_images`; and
last `{"recommendation": the cheapest set}`. `--tiny`: every size and bucket
divided by 16 (rounded up).
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List, Tuple

CHUNKS_PER_IMAGE, CHUNK_BATCH = 31, 4

# (resized_h, resized_w, fraction): the COCO / LVIS mix at min 800 / max 1333
SIZE_DISTRIBUTION = (
    (800, 1067, 0.47),   # 4:3 landscape (640x480, 500x375, ...)
    (800, 1200, 0.12),   # 3:2 landscape
    (800, 1333, 0.06),   # wide landscape, capped at MAX_SIZE_TEST
    (1067, 800, 0.22),   # 4:3 portrait
    (1200, 800, 0.05),   # 3:2 portrait
    (1333, 800, 0.03),   # tall portrait, capped
    (800, 880, 0.05),    # near-square
)

# candidate TPU.IMAGE_BUCKETS sets (orientation-free entries)
BUCKET_SETS = {
    "single-1344": ((800, 1344),),
    "two-1088+1344": ((800, 1088), (800, 1344)),
    "three-1088+1216+1344": ((800, 1088), (800, 1216), (800, 1344)),
    "square-1344 (orientation-free, 1 compile)": ((1344, 1344),),
}


def scaled(scale: int):
    """(SIZE_DISTRIBUTION, BUCKET_SETS) with every size divided by `scale`,
    rounded up (1: as they are)."""
    def s(x):
        return -(-x // scale)

    sizes = tuple((s(h), s(w), f) for h, w, f in SIZE_DISTRIBUTION)
    sets = {k: tuple((s(h), s(w)) for h, w in v) for k, v in BUCKET_SETS.items()}
    return sizes, sets


def geometries(sizes, sets) -> List[Tuple[int, int]]:
    """Every padded geometry a set uses, by pixel count."""
    from mqdet_torch.data.transforms import pick_bucket

    geoms = {pick_bucket(h, w, buckets) for buckets in sets.values() for h, w, _ in sizes}
    return sorted(geoms, key=lambda g: (g[0] * g[1], g))


def measure(model, cfg, geoms, runs: int = 7, seed: int = 0, emit=None):
    """({geometry: protocol p50 ms}, {geometry: first call s}, {geometry:
    kernel launches of its first call}) of `model` (MQ-GLIP) on its device."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools import host_ms
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch
    from mqdet_torch.utils.profiling import device_fence

    dev = next(model.parameters()).device
    groups = -(-CHUNKS_PER_IMAGE // CHUNK_BATCH)
    p50, first, launches, by_pixels = {}, {}, {}, {}
    for geom in geoms:
        image, text = protocol_inputs(cfg, synthetic_batch, groups, CHUNK_BATCH, geom, seed)
        image, text = image.to(dev), [t.to(dev) for t in text]
        protocol = make_protocol_fn(model, geom, cfg)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        device_fence(protocol(image, *text))
        first[geom] = time.perf_counter() - t0
        launches[geom] = {k: v for k, v in launch_counts().items() if v}
        pix = geom[0] * geom[1]
        if pix not in by_pixels:
            by_pixels[pix] = statistics.median(host_ms(lambda: protocol(image, *text), runs, 0))
        p50[geom] = by_pixels[pix]
        if emit is not None:
            emit({"geometry": list(geom), "first_call_s": first[geom], "protocol_p50_ms": p50[geom],
                  "launches": launches[geom]})
    return p50, first, launches


def bucket_sets_report(p50_ms: Dict, first_call_s: Dict, n_images: int, sizes=SIZE_DISTRIBUTION,
                       sets=None) -> List[Dict]:
    """Per bucket set (module docstring), cheapest first, then the
    recommendation."""
    from mqdet_torch.data.transforms import pick_bucket

    results = []
    for name, buckets in (sets or BUCKET_SETS).items():
        used = {}
        pad_waste = per_image = 0.0
        for h, w, frac in sizes:
            g = pick_bucket(h, w, buckets)
            used[g] = True
            per_image += frac * p50_ms[g] / 1000.0
            pad_waste += frac * (g[0] * g[1] - h * w) / (h * w)
        first = sum(first_call_s[g] for g in used)
        results.append({
            "bucket_set": name, "geometries_compiled": [list(g) for g in used], "first_call_total_s": first,
            "avg_s_per_image": per_image, "avg_padding_waste_pct": 100 * pad_waste,
            "total_eval_s_at_N": first + n_images * per_image, "n_images": n_images,
        })
    results.sort(key=lambda r: r["total_eval_s_at_N"])
    return results + [{"recommendation": results[0]["bucket_set"]}]


def churn(model, cfg, n_images: int = 5000, runs: int = 7, scale: int = 1, emit=None) -> List[Dict]:
    """The module docstring's lines for `model`: per geometry, then per set."""
    sizes, sets = scaled(scale)
    p50, first, _ = measure(model, cfg, geometries(sizes, sets), runs, emit=emit)
    out = bucket_sets_report(p50, first, n_images, sizes, sets)
    for rec in out:
        if emit is not None:
            emit(rec)
    return out


def main(argv=None) -> int:
    from mqdet_torch.tools import device_name, emit, glip_t, tool_args

    def extra(ap):
        ap.add_argument("--n-images", type=int, default=5000)
        ap.add_argument("--runs", type=int, default=7)

    args, dev = tool_args(__doc__.split("\n")[0], argv, extra)
    model, cfg, _ = glip_t(args.tiny, dev)
    churn(model, cfg, args.n_images, args.runs, 16 if args.tiny else 1, emit=emit)
    emit({"device": device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
