"""Runtime layer (counterpart of ``dislib_tpu/runtime``): the health
vector and ``NumericalDivergence``, and the chunked fit loop
(:mod:`~dislib_tpu_torch.runtime.loop`) that stands for the reference's
data-dependent ``lax.while_loop`` loops, in this slice."""
