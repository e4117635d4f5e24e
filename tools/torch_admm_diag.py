#!/usr/bin/env python3
"""The consensus ADMM's agent Grams and a Lasso fit with 4 agents on the
card, against float64.

Run from the root of a checkout::

    PYTHONPATH=. python3 tools/torch_admm_diag.py

It prints the card's name and power limit, then one JSON line: on the
regressions' draw of ``chip_smoke.lr_data`` (1,000,000 × 100) split into
4 agents of 250,000 rows, the largest error of agent 0's Gram AᵀA,
relative to its largest entry, against float64 when it is one product of
the batch of 4 agents (``bmm``), of a batch of one and of a plain ``mm``,
all with TF32 off; then ``Lasso`` (``chip_smoke``'s λ and ρ) fitted with
4 agents in float32 and in float64, each coefficient's largest distance
from a float64 NumPy ADMM with 4 agents run for the same steps.
"""

import importlib
import json
import subprocess

import numpy as np
import torch

import chip_smoke as cs
import dislib_tpu_torch as dst
from dislib_tpu_torch.ops import precision as px

P = 4


def numpy_admm(x, y, rho, kappa, steps, p=P):
    """Consensus ADMM over p contiguous row blocks in float64."""
    a = x.reshape(p, -1, x.shape[1])
    b = y.reshape(p, -1)
    chol = [np.linalg.cholesky(a[i].T @ a[i] + rho * np.eye(x.shape[1]))
            for i in range(p)]
    atb = [a[i].T @ b[i] for i in range(p)]
    xi = np.zeros((p, x.shape[1]))
    ui = np.zeros_like(xi)
    z = np.zeros(x.shape[1])
    for _ in range(steps):
        xi = np.stack([np.linalg.solve(chol[i].T, np.linalg.solve(
            chol[i], atb[i] + rho * (z - ui[i]))) for i in range(p)])
        zm = (xi + ui).mean(0)
        z = np.sign(zm) * np.maximum(np.abs(zm) - kappa, 0)
        ui = ui + xi - z
    return z


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dst.init(device="cuda:0")
    admm = importlib.import_module("dislib_tpu_torch.optimization.admm")
    x, _, yl = cs.lr_data(cs.LR_M, cs.LR_N)
    x64 = x.astype(np.float64)
    g64 = x64[: cs.LR_M // P].T @ x64[: cs.LR_M // P]
    xt = torch.from_numpy(x).cuda().reshape(P, -1, cs.LR_N)
    out = {}
    with px.precise():
        for name, g in (("bmm_of_4", (xt.mT @ xt)[0]),
                        ("bmm_of_1", (xt[:1].mT @ xt[:1])[0]),
                        ("mm", xt[0].T @ xt[0])):
            out[f"gram_rel_err_{name}"] = float(
                np.abs(g.double().cpu().numpy() - g64).max()
                / np.abs(g64).max())
    agents = admm._agents
    admm._agents = lambda: P
    try:
        fits = {name: dst.Lasso(lmbd=cs.LASSO_LMBD, rho=cs.LASSO_RHO,
                                max_iter=cs.LASSO_ITERS).fit(
                                    dst.array(x, dtype=dt),
                                    dst.array(yl, dtype=dt))
                for name, dt in (("f32", np.float32), ("f64", np.float64))}
    finally:
        admm._agents = agents
    z = numpy_admm(x64, yl.astype(np.float64).ravel(), cs.LASSO_RHO,
                   cs.LASSO_LMBD / (cs.LASSO_RHO * P), fits["f32"].n_iter_)
    for name, est in fits.items():
        out[f"lasso_{name}_n_iter"] = est.n_iter_
        out[f"lasso_{name}_max_abs_err_vs_numpy64"] = float(
            np.abs(est.coef_ - z).max())
    out["largest_coef"] = float(np.abs(z).max())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
