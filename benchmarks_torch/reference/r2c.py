"""The plain 3D real-to-complex transform and its inverse (numpy's
conventions: unnormalised forward, 1/N inverse), axis by axis: the r2c
along z, then the c2c along y and x; the inverse in the mirror order."""

import torch

from . import dtypes


class R2C:
    """``fftn``/``ifftn`` of real (N0, N1, N2) fields in ``precision``
    ("float64", or "tf32": float32 with each stage's input rounded to
    TF32, the control)."""

    def __init__(self, N, precision="float64"):
        self.N = tuple(int(n) for n in N)
        self.rdt, self.cdt, self.rnd = dtypes(precision)

    def _in(self, x):
        return x if self.rnd is None else self.rnd(x)

    def fftn(self, u):
        X = torch.fft.rfft(self._in(u.to(self.rdt)), dim=-1)
        X = torch.fft.fft(self._in(X), dim=-2)
        return torch.fft.fft(self._in(X), dim=-3)

    def ifftn(self, X):
        X = torch.fft.ifft(self._in(X.to(self.cdt)), dim=-3)
        X = torch.fft.ifft(self._in(X), dim=-2)
        return torch.fft.irfft(self._in(X), n=self.N[-1], dim=-1)
