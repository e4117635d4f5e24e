"""Utilities (counterpart of ``dislib_tpu/utils``): host-read accounting."""
