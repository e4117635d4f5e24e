"""Checkpoint adoption — the gated read side of model hot-swap.

Counterpart of ``dislib_tpu/runtime/adoption.py`` (host code, kept as a
copy of its own, over the port's ``FitCheckpoint`` and
``runtime/health.py``).  ``FitCheckpoint`` is crash-consistent on the
write side: rotating generations, embedded checksums, atomic rename,
corrupt-newest fallback.  This module is the matching read side for a
consumer that serves generation N while generation N+1 trains: a reader
polls the rotating checkpoint and adopts a new generation only after

1. the checksum-verified load succeeds (``checkpoint.load()`` — a torn or
   bit-corrupt newest generation falls back to the previous good one, so
   a reader never observes a torn model), and
2. the health gates pass: the snapshot's numeric state must be finite,
   and the caller's ``probe`` (the serving warmup, which captures the
   candidate's CUDA graphs) must predict finite values — else a typed
   :class:`AdoptionRejected`.

The serving layer (``dislib_tpu_torch.serving``) reads a model only
through :func:`adopt_latest`, which an AST lint in
``tests/test_torch_serving.py`` enforces.  Writers and readers share only
the checkpoint path; each side builds its own ``FitCheckpoint``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["Adoption", "AdoptionRejected", "adopt_latest",
           "generation_token"]


class AdoptionRejected(RuntimeError):
    """A candidate generation failed the adoption gate (non-finite warmup
    predictions, or the caller's ``validate`` refused it).  Carries the
    generation ``token`` and the health ``detail`` for the postmortem."""

    def __init__(self, message, token=None, detail=None):
        super().__init__(message)
        self.token = token
        self.detail = detail or {}


class Adoption:
    """One successful adoption: the generation ``token`` (pass it back as
    ``last_token`` on the next poll), the verified snapshot ``state``
    dict, the built ``model``, and ``mtime_ns`` — the write time of the
    file the state actually came from (pass it back as ``min_mtime_ns``
    so a later disk fallback can never move the served model BACKWARDS)."""

    __slots__ = ("token", "state", "model", "mtime_ns")

    def __init__(self, token, state, model, mtime_ns=None):
        self.token = token
        self.state = state
        self.model = model
        self.mtime_ns = mtime_ns

    def __repr__(self):
        return f"Adoption(token={self.token!r})"


def generation_token(checkpoint):
    """Cheap change-detection token for the newest generation on disk:
    ``(inode, mtime_ns, size)`` of the first generation file that exists,
    or None when the checkpoint has no generation at all.  Every
    ``FitCheckpoint.save`` lands via an atomic rename of a fresh temp
    file, so a new generation ALWAYS changes the inode — a poller
    comparing tokens cannot miss a swap or be fooled by an in-place
    mtime collision."""
    for i in range(checkpoint.keep):
        p = checkpoint._gen_path(i)
        try:
            st = os.stat(p)
        except OSError:
            continue
        return (i, st.st_ino, st.st_mtime_ns, st.st_size)
    return None


def adopt_latest(checkpoint, build, probe=None, validate=None,
                 last_token=None, min_mtime_ns=None, name="adoption"):
    """Adopt the newest verified-and-healthy checkpoint generation.

    Parameters
    ----------
    checkpoint : FitCheckpoint — the rotating snapshot a writer updates.
    build : callable(state_dict) -> model — turn the verified snapshot
        into a servable model (e.g. restore estimator attributes).
    probe : callable(model) -> prediction, optional — the warmup predict.
        Its output (ds-array or ndarray) is judged by the health
        layer's non-finite guard; a tripped guard raises
        :class:`AdoptionRejected` and the caller keeps serving the old
        generation.
    validate : callable(model, state), optional — extra caller-side gate;
        raise :class:`AdoptionRejected` inside it to refuse.
    last_token : token from the previous :class:`Adoption`, or None.
    min_mtime_ns : the previous Adoption's ``mtime_ns``, or None.  The
        monotonicity guard: when the verified load FALLS BACK (newest
        file corrupt) to a generation whose file is not newer than the
        one already served, return None instead of adopting — the
        in-memory model passed its gate when it was adopted, and disk rot
        AFTER adoption must never downgrade the served generation (the
        serving soak's no-stale-after-adoption invariant).
    name : str — guard label in health diagnostics.

    Returns None when there is nothing new to adopt (no generation on
    disk, or the newest one is the already-adopted ``last_token``);
    otherwise an :class:`Adoption`.  Raises ``SnapshotCorrupt`` only when
    EVERY generation on disk is damaged (the `FitCheckpoint.load`
    contract), and :class:`AdoptionRejected` when the candidate fails the
    health gate.

    The token is captured BEFORE the load: if the newest file is corrupt,
    ``load()`` falls back to (and cleans up to) an older good generation,
    and the next poll re-adopts once against the settled state — a benign
    duplicate, where capturing after the load could instead MISS a
    generation written mid-adoption.
    """
    token = generation_token(checkpoint)
    if token is None or token == last_token:
        return None
    state = checkpoint.load()
    if state is None:
        return None
    # the monotonicity floor must UNDERESTIMATE the loaded state's write
    # time: too high and a newer generation gets skipped forever (stale
    # serving); too low and the next poll merely re-adopts (benign).
    # Neither single stat is safe alone — after a corrupt-newest
    # fallback the pre-load token is the corrupt file's (too high), and
    # when a writer lands a brand-new generation mid-load the post-load
    # token is that newer file's (too high).  The min of the two is
    # correct in both cases and exact in the common no-race path.
    post = generation_token(checkpoint)
    mtime_ns = min(token[2], post[2]) if post is not None else token[2]
    if min_mtime_ns is not None and mtime_ns <= min_mtime_ns:
        return None
    from dislib_tpu_torch.runtime import health as _health
    # gate 1 — the snapshot PARAMETERS must be finite.  The probe alone
    # is vacuous for integer-label pipelines (argmin over all-NaN scores
    # yields perfectly finite int32 labels), so NaN centers/means/coefs
    # are caught here, at the state they live in — the read-side twin of
    # the "snapshot writes gated on healthy chunks" invariant.
    numeric = {k: v for k, v in state.items()
               if np.issubdtype(np.asarray(v).dtype, np.number)}
    verdict = _health.guard(name).check_host(numeric)
    if not verdict.ok:
        raise AdoptionRejected(
            f"{name}: candidate generation carries non-finite state "
            f"(guard {verdict.guard!r}, detail: {verdict.detail}) — "
            "keeping the previous generation",
            token=token, detail=verdict.detail)
    model = build(state)
    if probe is not None:
        # gate 2 — the warmup predict's own outputs (catches a compute
        # path that manufactures non-finite values from finite state)
        out = probe(model)
        from dislib_tpu_torch.runtime.elastic import fetch as _fetch
        host = _fetch(out) if hasattr(out, "_data") else np.asarray(out)
        verdict = _health.guard(name).check_host({"warmup_predict": host})
        if not verdict.ok:
            raise AdoptionRejected(
                f"{name}: candidate generation failed its health-gated "
                f"warmup predict (guard {verdict.guard!r}, detail: "
                f"{verdict.detail}) — keeping the previous generation",
                token=token, detail=verdict.detail)
    if validate is not None:
        validate(model, state)
    return Adoption(token, state, model, mtime_ns)
