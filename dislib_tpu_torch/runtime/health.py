"""Runtime health layer — the fused numerical-health vector.

Counterpart of ``dislib_tpu/runtime/health.py``, reduced to
:func:`health_vec`, which the KMeans fit returns and the forest judges at
adoption, and :class:`NumericalDivergence`, which that judgement raises.
The guard, watchdog and rollback machinery around them (``ChunkGuard``,
``HealthPolicy``, the ``ChunkedFitLoop``) is ROADMAP.md A.12.
"""

from __future__ import annotations

import torch

__all__ = ["health_vec", "HEALTH_BASE_LEN", "NumericalDivergence"]

# fixed slots of a health vector; per-carry (count, first_flat_index)
# pairs follow
HEALTH_BASE_LEN = 9


class NumericalDivergence(RuntimeError):
    """A fit's numerical state went bad (non-finite carries, diverging
    loss, exploding norms).  Carries what a postmortem needs: the
    estimator, the iteration the guard tripped at, which guard, and the
    offending carry coordinates."""

    def __init__(self, message, estimator=None, iteration=None, guard=None,
                 detail=None):
        super().__init__(message)
        self.estimator = estimator
        self.iteration = iteration
        self.guard = guard
        self.detail = detail or {}


def _masked_max(x: torch.Tensor) -> torch.Tensor:
    """max(0, max(x)) — 0 for an empty x (``jnp.max(initial=0.0)``)."""
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.clamp_min(x.max().to(torch.float32), 0.0)


def health_vec(carries=(), inputs=(), hist=None, n_done=None,
               increasing=False) -> torch.Tensor:
    """Build the (HEALTH_BASE_LEN + 2·len(carries),) float32 health vector
    on the device, from a fit's final carries, without a host sync.

    Layout: ``[carry_nonfinite_total, input_nonfinite_total, rise, scale,
    max_abs_carry, loss_nonfinite, loss_valid, loss_first, loss_last,
    (count, first_flat_index) per carry]`` — the reference's layout.
    ``hist``/``n_done``: the per-iteration loss history (slots beyond
    ``n_done`` ignored); ``rise`` is the worst consecutive violation of
    monotonicity (losses must fall, or rise when ``increasing=True``) and
    ``scale`` its reference magnitude."""
    tensors = [torch.as_tensor(t) for t in (*carries, *inputs)]
    if hist is not None:
        tensors.append(torch.as_tensor(hist))
    dev = tensors[0].device if tensors else torch.device("cpu")
    z = torch.zeros((), dtype=torch.float32, device=dev)

    def _nf_pair(c):
        c = torch.as_tensor(c)
        if not torch.is_floating_point(c) or c.numel() == 0:
            return z, z
        bad = ~torch.isfinite(c.reshape(-1))
        count = bad.sum().to(torch.float32)
        first = bad.to(torch.uint8).argmax().to(torch.float32)  # 0 if none
        return count, first

    pairs = [_nf_pair(c) for c in carries]
    carry_nf = sum((p[0] for p in pairs), z)
    input_nf = sum((_nf_pair(x)[0] for x in inputs), z)
    max_abs = z
    for c in carries:
        c = torch.as_tensor(c)
        if torch.is_floating_point(c):
            # NaNs must not mask a finite blow-up elsewhere; they already
            # trip the nonfinite guard themselves
            a = c.reshape(-1).abs()
            max_abs = torch.maximum(max_abs, _masked_max(
                torch.where(torch.isfinite(a), a, torch.zeros_like(a))))
    rise = scale = loss_nf = loss_valid = loss_first = loss_last = z
    if hist is not None:
        hist = torch.as_tensor(hist).to(torch.float32).reshape(-1)
        n = hist.shape[0]
        if n >= 1:
            idx = torch.arange(n, device=dev)
            done = torch.as_tensor(n if n_done is None else n_done,
                                   device=dev).to(torch.int64)
            valid = idx < done
            fin = torch.isfinite(hist)
            loss_nf = (valid & ~fin).sum().to(torch.float32)
            scale = _masked_max(torch.where(valid & fin, hist.abs(),
                                            torch.zeros_like(hist)))
            ran = done >= 1
            loss_valid = ran.to(torch.float32)
            h0 = hist[0]
            hl = hist[torch.clamp(done - 1, 0, n - 1)]
            loss_first = torch.where(ran & torch.isfinite(h0), h0, z)
            loss_last = torch.where(ran & torch.isfinite(hl), hl, z)
            loss_valid = torch.where(torch.isfinite(h0) & torch.isfinite(hl),
                                     loss_valid, z)
            if n >= 2:
                diffs = hist[1:] - hist[:-1]
                dvalid = (idx[1:] < done) & torch.isfinite(diffs)
                viol = -diffs if increasing else diffs
                rise = _masked_max(torch.where(dvalid, viol,
                                               torch.zeros_like(viol)))
    out = [carry_nf, input_nf, rise, scale, max_abs, loss_nf, loss_valid,
           loss_first, loss_last]
    for count, first in pairs:
        out.extend([count, first])
    return torch.stack([o.to(torch.float32) for o in out])
