"""Compute kernels: hand-written CUDA FFT stages (``fft3d``) and the
``torch.fft`` route (``fft_core``)."""
