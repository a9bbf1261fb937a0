"""Quickstart: the paper's transitive sparsity in five minutes (port of
``examples/quickstart.py``).

1. Bit-slice a quantized weight matrix into TransRows.
2. Build the dynamic Scoreboard (Hasse forest) and inspect its statistics.
3. Execute the GEMM through transitive reuse — bit-exact vs int matmul.
4. Run the same math through the doubling-LUT kernel on the device: on
   the card the CUDA kernel ``tgemm_lut`` (``csrc/transitive_gemm.cu``),
   on the CPU its plain PyTorch version.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bitslice, transitive
from repro_torch.core.patterns import tile_stats
from repro_torch.core.scoreboard import dynamic_scoreboard
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(device=None) -> dict:
    """Run the four steps on ``device`` (``cuda`` unless asked otherwise);
    returns what they print: the TransRow shape, the mean density and
    patterns per tile, and the operands and results of steps 3 and 4
    (``w`` (N, K), ``x`` (K, M), ``out`` int64 (N, M), ``out_kernel``
    int32 (M, N) on the host)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    # --- 1. quantized weights -> binary TransRows --------------------------
    W = rng.integers(-8, 8, size=(64, 64))            # int4 weights (N x K)
    X = rng.integers(-128, 128, size=(64, 32))        # int8 activations (K x M)
    rows = bitslice.transrow_matrix(W, bits=4, t=8)   # (S=4, N=64, K/T=8)
    print(f"TransRows: {rows.shape} (S x N x K/T), values < 2^8")

    # --- 2. the Scoreboard --------------------------------------------------
    tiles = rows.transpose(2, 0, 1).reshape(8, -1)    # one tile per k-chunk
    st = tile_stats(dynamic_scoreboard(tiles, t=8))
    density = float(st.density.mean())
    patterns = {p: float(getattr(st, p).mean()) for p in ("pr", "fr", "tr",
                                                          "zr")}
    print(f"density  : {density:.3f}  (dense=1.0, paper bound 1/8)")
    print(f"patterns : PR={patterns['pr']:.0f} FR={patterns['fr']:.0f} "
          f"TR={patterns['tr']:.0f} ZR={patterns['zr']:.0f} per tile")

    # --- 3. lossless transitive GEMM ---------------------------------------
    out = transitive.transitive_gemm(W, X, bits=4, t=8)
    ref = W.astype(np.int64) @ X.astype(np.int64)
    if not (out == ref).all():
        raise AssertionError("transitive GEMM differs from the int GEMM")
    print("transitive GEMM == int GEMM: bit-exact ✓")

    # --- 4. the doubling-LUT kernel on the device --------------------------
    qx = torch.as_tensor(X.T, dtype=torch.int8, device=device)  # (M, K)
    qw = torch.as_tensor(W, dtype=torch.int8, device=device)
    out_k = ops.transitive_gemm(qx, qw, w_bits=4, t=8).cpu()
    if not (out_k.numpy() == ref.T).all():
        raise AssertionError(f"the transitive kernel on {device} differs "
                             f"from the int GEMM")
    what = "CUDA kernel" if device.type == "cuda" else "plain version"
    print(f"transitive LUT {what} on {device}: bit-exact ✓")
    return {"rows_shape": rows.shape, "density": density,
            "patterns": patterns, "w": W, "x": X, "out": out,
            "out_kernel": out_k}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
