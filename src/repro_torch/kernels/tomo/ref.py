"""Plain PyTorch versions: parallel-beam forward/back projection + the
GridRec ramp filter.

Discretization (as the JAX package's ``repro/kernels/tomo/ref.py``): image
(n, n), pixel centers at integer offsets from the image center; detector
with ``n_det`` bins, 1-pixel pitch, centered. For angle theta, the pixel in
(row, col) projects to detector coordinate

    s = (col - c) * cos(theta) + (row - c) * sin(theta) + (n_det - 1) / 2

with linear interpolation between the two neighbouring bins; bins outside
``[0, n_det)`` are dropped. Forward projection uses the exact adjoint
weights of backprojection, which is what ML-EM convergence requires.

The JAX reference builds a dense one-hot (n^2, n_det) weight matrix per
angle; at n = 1448 that is 12 GB. These versions compute the same
function by gathering (backprojection) or scatter-adding (projection) the
two bins of every pixel, a chunk of angles at a time. ``s`` is rounded
after every product and sum, exactly as the CUDA kernels round it, so both
give each (pixel, bin) pair the same weight.
"""
from __future__ import annotations

import torch

#: elements of one (batch, angle chunk, pixel) temporary
_CHUNK_ELEMS = 1 << 25


def trig(angles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the angles in f32 (both projectors' inputs)."""
    a = angles.to(torch.float32)
    return torch.cos(a).contiguous(), torch.sin(a).contiguous()


def _angle_chunk(batch: int, n_pix: int) -> int:
    return max(1, _CHUNK_ELEMS // max(batch * n_pix, 1))


def detector_coords(n: int, n_det: int, cos_t: torch.Tensor, sin_t: torch.Tensor):
    """(s0, f) for every (angle, pixel): s0 = floor(s) as int64 (A, n*n) and
    f = s - s0 (A, n*n) f32. Bin s0 weighs 1 - f, bin s0 + 1 weighs f."""
    coords = torch.arange(n, dtype=torch.float32, device=cos_t.device) - (n - 1) / 2.0
    x = coords[None, None, :]  # columns
    y = coords[None, :, None]  # rows
    s = x * cos_t[:, None, None] + y * sin_t[:, None, None] + (n_det - 1) / 2.0
    s = s.reshape(cos_t.shape[0], n * n)
    fl = torch.floor(s)
    return fl.to(torch.int64), s - fl


def _gather_bins(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows (B, C, n_det) gathered at idx (C, P) -> (B, C, P); bins outside
    [0, n_det) read as 0."""
    n_det = rows.shape[-1]
    valid = (idx >= 0) & (idx < n_det)
    b = rows.shape[0]
    g = torch.gather(rows, 2, idx.clamp(0, n_det - 1).expand(b, -1, -1))
    return torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device))


def backproject_plain(sinos: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor,
                      n: int) -> torch.Tensor:
    """sinograms (B, A, n_det) -> images (B, n, n) (unfiltered adjoint), on
    precomputed cos/sin of the A angles."""
    b, a, n_det = sinos.shape
    rows_all = sinos.to(torch.float32)
    out = torch.zeros((b, n * n), dtype=torch.float32, device=sinos.device)
    step = _angle_chunk(b, n * n)
    for a0 in range(0, a, step):
        s0, f = detector_coords(n, n_det, cos_t[a0:a0 + step], sin_t[a0:a0 + step])
        rows = rows_all[:, a0:a0 + step]
        contrib = (1.0 - f) * _gather_bins(rows, s0) + f * _gather_bins(rows, s0 + 1)
        out += contrib.sum(dim=1)
    return out.reshape(b, n, n)


def project_plain(imgs: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor,
                  n_det: int) -> torch.Tensor:
    """images (B, n, n) -> sinograms (B, A, n_det), on precomputed cos/sin
    of the A angles: every pixel adds to its two bins."""
    b, n = imgs.shape[0], imgs.shape[-1]
    a = cos_t.shape[0]
    flat = imgs.reshape(b, 1, n * n).to(torch.float32)
    out = torch.empty((b, a, n_det), dtype=torch.float32, device=imgs.device)
    step = _angle_chunk(b, n * n)
    for a0 in range(0, a, step):
        s0, f = detector_coords(n, n_det, cos_t[a0:a0 + step], sin_t[a0:a0 + step])
        c = s0.shape[0]
        # one spare bin per row collects the out-of-range contributions
        acc = torch.zeros((b, c, n_det + 1), dtype=torch.float32, device=imgs.device)
        for idx, w in ((s0, 1.0 - f), (s0 + 1, f)):
            idx = torch.where((idx >= 0) & (idx < n_det), idx, n_det)
            acc.scatter_add_(2, idx.expand(b, -1, -1), w * flat)
        out[:, a0:a0 + c] = acc[..., :n_det]
    return out


def project_ref(img: torch.Tensor, angles: torch.Tensor, n_det: int) -> torch.Tensor:
    """img (n, n) -> sinogram (A, n_det)."""
    return project_ref_batch(img[None], angles, n_det)[0]


def backproject_ref(sino: torch.Tensor, angles: torch.Tensor, n: int) -> torch.Tensor:
    """sinogram (A, n_det) -> image (n, n) (unfiltered adjoint)."""
    return backproject_ref_batch(sino[None], angles, n)[0]


def project_ref_batch(imgs: torch.Tensor, angles: torch.Tensor, n_det: int) -> torch.Tensor:
    """imgs (B, n, n) -> sinograms (B, A, n_det)."""
    return project_plain(imgs, *trig(angles.to(imgs.device)), n_det)


def backproject_ref_batch(sinos: torch.Tensor, angles: torch.Tensor, n: int) -> torch.Tensor:
    """sinograms (B, A, n_det) -> images (B, n, n)."""
    return backproject_plain(sinos, *trig(angles.to(sinos.device)), n)


# ---------------------------------------------------------------------------
# reconstruction pieces (paper §3.2.2 / §5)
# ---------------------------------------------------------------------------


def ramp_filter(sino: torch.Tensor, *, window: str = "ramlak") -> torch.Tensor:
    """Frequency-domain ramp filter along the detector axis (GridRec's FFT
    step; a library FFT, as in the JAX package, which leaves it to XLA)."""
    n_det = sino.shape[-1]
    freqs = torch.fft.fftfreq(n_det, dtype=torch.float32, device=sino.device)
    filt = freqs.abs()
    if window == "shepp":
        filt = filt * torch.sinc(freqs)
    spec = torch.fft.fft(sino.to(torch.float32), dim=-1)
    return torch.fft.ifft(spec * filt, dim=-1).real.contiguous()

