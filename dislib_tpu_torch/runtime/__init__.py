"""Runtime layer (counterpart of ``dislib_tpu/runtime``): the health
vector and ``NumericalDivergence`` only, in this slice."""
