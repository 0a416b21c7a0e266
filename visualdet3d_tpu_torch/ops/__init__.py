"""Ops of the port; kernels are built by ``kernel_build``."""
