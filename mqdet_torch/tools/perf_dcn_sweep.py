"""Sweep the band DCN kernel's versions and block rows at the LVIS level-0
shape on one NVIDIA GPU (the port of `tools/perf_dcn_sweep.py`).

    python -m mqdet_torch.tools.perf_dcn_sweep [versions] [block_rows]

  versions    comma-separated band kernel versions (default "2,5"): 1, 2, 3,
              5, 6 (`ops.deform_conv.modulated_deform_conv_pallas`)
  block_rows  comma-separated tile rows (default "8")

The inputs are the JAX tool's, from numpy's default_rng(0): x (4, 100, 168,
256) bf16 at stride 1, radius 2, and two offset regimes: `rand`, white noise
x0.5 per position (the worst case for version 5's uniform tiles), and
`smooth`, a 7x11 field upsampled by 15x16 (what conv-produced offsets look
like). One JSON line per (regime, version, block_rows): the median time of
one launch over ITERS CUDA-event-timed launches after WARMUP, the card's name
and power limit (nvidia-smi), version 5's share of fast-path (tile, tap)
pairs, and `max_err_vs_v2ref`, the max |difference| from the first version
listed (its first block_rows); a case that fails prints an `error` record. It
exits non-zero on a machine without a CUDA device.
"""
from __future__ import annotations

import json
import sys

from mqdet_torch.tools import card, cuda_time_ms

ITERS, WARMUP = 10, 2


def parse_args(argv):
    """([versions], [block_rows]) from the two optional positional arguments."""
    versions = tuple(int(v) for v in (argv[0] if len(argv) > 0 else "2,5").split(","))
    brs = tuple(int(v) for v in (argv[1] if len(argv) > 1 else "8").split(","))
    return versions, brs


def sweep_inputs(dev):
    """x, {regime: offset}, mask, weight, bias on `dev`, in the JAX tool's draw order."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    cp = 4
    x0 = rng.standard_normal((cp, 100, 168, 256))
    off_rand = rng.standard_normal((cp, 100, 168, 18)) * 0.5
    low = rng.standard_normal((cp, 7, 11, 18)) * 1.0
    off_smooth = np.kron(low, np.ones((1, 15, 16, 1)))[:, :100, :168, :]
    m0 = rng.uniform(0, 1, (cp, 100, 168, 9))
    wt = rng.standard_normal((3, 3, 256, 256)) * 0.02

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, torch.bfloat16)

    offs = {"rand": bf(off_rand), "smooth": bf(off_smooth)}
    return bf(x0), offs, bf(m0), bf(wt), torch.zeros(256, dtype=torch.bfloat16, device=dev)


def sweep(versions, brs, dev):
    """Yields one record per (regime, version, block_rows); each case makes
    1 + WARMUP + ITERS launches."""
    import torch

    from mqdet_torch.ops.deform_conv import band_fast_share, modulated_deform_conv_pallas

    x0, offs, m0, wt, bs = sweep_inputs(dev)
    name = card()
    for regime, off0 in offs.items():
        ref = None
        for version in versions:
            for br in brs:
                rec = {"regime": regime, "version": version, "block_rows": br, "card": name}
                try:
                    def call(_v=version, _b=br):
                        return modulated_deform_conv_pallas(x0, off0, m0, wt, bs, stride=1, radius=2,
                                                            block_rows=_b, version=_v)

                    out1 = call().float()
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = out1
                    else:
                        rec["max_err_vs_v2ref"] = float((out1 - ref).abs().max())
                    rec["ms"] = cuda_time_ms(call, ITERS, WARMUP)
                    if version == 5:
                        rec["fast_share"] = band_fast_share(off0, 1, 2, br)
                except Exception as e:  # noqa: BLE001 - a failed case is a record, the sweep goes on
                    rec = {"regime": regime, "version": version, "block_rows": br, "card": name,
                           "error": f"{type(e).__name__}: {e}"[:200]}
                yield rec


def main(argv=None) -> int:
    versions, brs = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("perf_dcn_sweep: no CUDA device; it measures only on a GPU", file=sys.stderr)
        return 1
    for rec in sweep(versions, brs, torch.device("cuda")):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
