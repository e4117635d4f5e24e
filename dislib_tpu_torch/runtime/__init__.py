"""Runtime layer (counterpart of ``dislib_tpu/runtime``): the health
vector only, in this slice."""
