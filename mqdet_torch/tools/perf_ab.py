"""Two checkouts' kernels on one card, in turns: the band DCN kernel (K1,
version 2, block rows 16) at MQ-GLIP-T's level 0, x (4, 100, 168, 256)
stride 1 with offsets x3, and the clipped MSDA kernel (K5) at
MQ-GroundingDINO-T's encoder shape, value (4, 22323, 8, 32) with locations
N(0, 2 cells) around each query's own cell.

    python -m mqdet_torch.tools.perf_ab <root of the other checkout>

The other checkout (A: for example the parent commit, unpacked with `git
archive` into a directory that .gitignore lists) and this one (B) run in the
order A, B, B, A, each in its own process that imports the package of its
checkout and builds that checkout's kernels. One JSON line per run: per
kernel `device_ms` (the mean device time of one call over 50 calls issued
back to back), `ms` (the median of 20 single calls between CUDA events,
the wrapper's host work included) and `sha`, a hash of the output on the
same seeded inputs (equal hashes: bitwise equal outputs); and the card's
name and power limit. It exits non-zero on a machine without a CUDA device.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def run_one(root: str, label: str) -> dict:
    """The timings of the package in `root` (imported from there)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import kernels
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.tools import card, cuda_time_ms, loop_ms

    if not kernels.library_path().startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {kernels.library_path()}, not the checkout at {root}")
    kernels.lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 100, 168, 256, generator=g, device=dev).bfloat16()
    off = (torch.randn(4, 100, 168, 18, generator=g, device=dev) * 3).bfloat16()
    mask = torch.rand(4, 100, 168, 9, generator=g, device=dev).bfloat16()
    w = (torch.randn(3, 3, 256, 256, generator=g, device=dev) * 0.03).bfloat16()
    bias = torch.randn(256, generator=g, device=dev).bfloat16()
    shapes = [(100, 168), (50, 84), (25, 42), (13, 21)]
    s = sum(h * wd for h, wd in shapes)
    value = torch.randn(4, s, 8, 32, generator=g, device=dev).bfloat16()
    centre = torch.cat([torch.stack(torch.meshgrid((torch.arange(wd, device=dev) + 0.5) / wd,
                                                   (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"), -1)
                        .reshape(-1, 2) for h, wd in shapes])
    wh = torch.tensor([[wd, h] for h, wd in shapes], dtype=torch.float32, device=dev)
    loc = centre[None, :, None, None, None, :] + (torch.randn(4, s, 8, 4, 4, 2, generator=g, device=dev) * 2.0
                                                  / wh[None, None, None, :, None, :])
    attn = torch.rand(4, s, 8, 4, 4, generator=g, device=dev)
    attn = attn / attn.sum(dim=(3, 4), keepdim=True)
    runs = {"dcn_band": lambda: dc.modulated_deform_conv_pallas(x, off, mask, w, bias, 1, 2, 16),
            "ms_deform_attn_clip": lambda: ms.ms_deform_attn(value, shapes, loc, attn)}
    out = {"tree": label, "card": card()}
    for name, fn in runs.items():
        y = fn()
        torch.cuda.synchronize()
        out[name] = {"device_ms": loop_ms(fn, iters=50), "ms": cuda_time_ms(fn, iters=20),
                     "sha": hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()[:16]}
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perf_ab: no CUDA device; it measures only on a GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, MQDET_MSDA_IMPL="pallas")
    for root, label in ((sys.argv[1], "A"), (here, "B"), (here, "B"), (sys.argv[1], "A")):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, f"{label} {root}"], env=env)
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
