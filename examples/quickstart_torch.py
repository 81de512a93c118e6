"""Quickstart on the PyTorch/CUDA port: the CSB-RNN pipeline in ~70 lines.

1. Take an LSTM layer's weight matrices.
2. CSB-prune them (projection only, no retraining here).
3. Encode into the CSB sparse format; inspect compression + NIO.
4. Run the CSB-MVM (the CUDA kernel on the card, its plain version on
   the CPU) and check it against the plain version.
5. Compile the workload-balanced schedule and simulate utilization.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the default device is the CUDA card).
"""
import argparse

import torch

from repro_torch.cells import init_params, make_cell
from repro_torch.core import (
    CSBMatrix, CSBSpec, csb_masks, csb_project, padded_csb_from_dense,
)
from repro_torch.engine import EngineConfig, simulate_matrix
from repro_torch.kernels import csb_matvec, csb_mvm_ref, pad_to_grid

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
dev = torch.device(parser.parse_args().device or "cuda")

gen = torch.Generator().manual_seed(0)
cell = make_cell("lstm", 128, 256)
params = init_params(cell, gen, device=dev)
spec = CSBSpec(bm=32, bn=32, prune_rate=0.875)   # 8x compression target

print(f"LSTM 128->256, {cell.param_count():,} params, on {dev}")
print(f"CSB spec: {spec.bm}x{spec.bn} blocks, "
      f"{spec.compression_ratio:.1f}x target\n")

total_nnz = total = 0
for name in ("W_i", "U_i"):                      # input + recurrent of gate i
    w = params[name]
    z = csb_project(w, spec)
    rm, cm = csb_masks(w, spec)
    csb = CSBMatrix.from_dense(z.cpu().numpy(), 32, 32,
                               rm.cpu().numpy(), cm.cpu().numpy())
    total_nnz += csb.nnz
    total += w.numel()
    print(f"{name}: {tuple(w.shape)} -> {csb.nnz:,} nnz "
          f"({csb.compression_ratio():.1f}x), NIO={csb.nio():.2f} "
          f"(CSR would be {CSBMatrix.csr_nio(csb.nnz, w.shape[0]):.2f})")

    # the CSB-MVM against its plain version on the same padded inputs
    p = padded_csb_from_dense(z, 32, 32, row_mask=rm, col_mask=cm,
                              device=dev)
    x = torch.randn(4, w.shape[1], generator=gen).to(dev)
    y = csb_matvec(p, x, device=dev)   # the CUDA kernel on the card
    xp = pad_to_grid(x, 8, p.grid[1] * p.block[1])
    y_plain = csb_mvm_ref(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                          grid=p.grid, block=p.block)[:4, :p.shape[0]]
    err = float((y - y_plain).abs().max())
    print(f"      kernel vs plain max err: {err:.2e}")

    # engine utilization with and without workload sharing (the paper
    # engine's cycle model at 200 MHz, not a GPU time)
    e = EngineConfig(K=4, L=4, P=4, Q=4)
    eff0 = simulate_matrix(csb, e, "none").efficiency
    res2 = simulate_matrix(csb, e, "2d")
    print(f"      engine: {eff0:.0%} util no-sharing -> "
          f"{res2.efficiency:.0%} with 2D sharing; {res2.latency_us:.2f} "
          f"us/MVM @200MHz (modelled)\n")

print(f"overall compression: {total / total_nnz:.1f}x")
