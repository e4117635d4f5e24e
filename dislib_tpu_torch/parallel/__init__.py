"""Device mesh (counterpart of ``dislib_tpu/parallel``)."""
