"""PyTorch/CUDA port of the device path of `sdr_receiver_dvb_t2_tpu`.

Same layout as the JAX package (`ops/`, `rx/`, `utils/`), plus `csrc/` for
the CUDA C++ kernels that replace its Pallas kernels, built at first use by
`_build.py`.  The package stands alone: it imports torch, never jax, and
nothing of the JAX package.  The NumPy host modules (`dvbt2/`, `tx/`, the
host receiver of `rx/`, `io/`, `native/`, `utils/`) are its own copies, kept
under the same relative paths; `utils/reference.py` turns the JAX package's
parameter objects into the port's.
"""
