"""The port's hand-written CUDA kernels (sources in `csrc/`), built with nvcc
at first use and bound with ctypes. Each launcher counts its launches."""
