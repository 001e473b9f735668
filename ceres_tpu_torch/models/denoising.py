"""Fields-of-Experts image denoising (port of
``ceres_tpu/models/denoising.py``, after ``examples/denoising.cc``,
``examples/fields_of_experts.{h,cc}`` and ``examples/pgm_image.h``): MAP
denoising with the quadratic data term sqrt(1/(2 sigma^2)) (x_ij - noisy_ij)
and a Fields-of-Experts prior, rho(s) = alpha log(1 + s/2) of the product of
each learned d x d filter with every image patch (Roth & Black, IJCV 2009).

Pixels are size-1 parameter blocks. Each filter is one residual family over
all (H-d+1)(W-d+1) patches with d^2 one-pixel arguments, whose ids are taken
column-major within the patch, so that every argument's ids rise with the
patch: each pixel-side reduction is a sorted segment sum over H*W pixels.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ceres_tpu_torch.loss import LossFunction, _param
from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.solver import SolverOptions
from ceres_tpu_torch.types import LinearSolverType, PreconditionerType


class FieldsOfExpertsLoss(LossFunction):
    """rho(s) = alpha log(1 + s/2) (fields_of_experts.cc:77-85)."""

    def __init__(self, alpha):
        self.alpha = _param(alpha)

    def evaluate(self, s):
        c = 0.5
        total = 1.0 + s * c
        inv = 1.0 / total
        return (
            self.alpha * torch.log(total),
            self.alpha * c * inv,
            -self.alpha * c * c * inv * inv,
        )


@dataclasses.dataclass
class FieldsOfExperts:
    """A loaded FoE model (fields_of_experts.cc:87-137)."""

    size: int  # filter side d
    alphas: np.ndarray  # (num_filters,)
    filters: np.ndarray  # (num_filters, d*d), column-major patch order

    @property
    def num_filters(self) -> int:
        return self.alphas.shape[0]


def load_foe_file(path) -> FieldsOfExperts:
    """Parse the .foe text format (fields_of_experts.cc:89-122)."""
    it = iter(Path(path).read_text().split())
    size = int(next(it))
    num_filters = int(next(it))
    if size < 0 or num_filters < 0:
        raise ValueError(f"{path}: invalid FoE header")
    n = size * size
    alphas = np.asarray([float(next(it)) for _ in range(num_filters)])
    filters = np.asarray([[float(next(it)) for _ in range(n)] for _ in range(num_filters)])
    return FieldsOfExperts(size=size, alphas=alphas, filters=filters)


def write_foe_file(path, foe: FieldsOfExperts) -> None:
    """Write the .foe text format that :func:`load_foe_file` reads."""
    lines = [f"{foe.size} {foe.num_filters}", " ".join(repr(float(a)) for a in foe.alphas)]
    lines += [" ".join(repr(float(v)) for v in f) for f in foe.filters]
    Path(path).write_text("\n".join(lines) + "\n")


def read_pgm(path) -> np.ndarray:
    """A minimal PGM (P2 / P5) reader (pgm_image.h)."""
    with open(path, "rb") as f:
        raw = f.read()
    parts = []
    for line in raw.split(b"\n"):
        hash_at = line.find(b"#")
        parts.append(line[:hash_at] if hash_at >= 0 else line)
    toks = b"\n".join(parts).split()
    magic = toks[0]
    w, h = int(toks[1]), int(toks[2])
    if magic == b"P2":
        data = np.asarray([int(t) for t in toks[4 : 4 + w * h]])
    elif magic == b"P5":
        # magic, width, height and maxval, comments skipped, then one
        # whitespace before the bytes
        seen, i = 0, 0
        while seen < 4:
            if raw[i : i + 1].isspace():
                while raw[i : i + 1].isspace():
                    i += 1
                continue
            if raw[i : i + 1] == b"#":
                while raw[i : i + 1] != b"\n":
                    i += 1
                continue
            while not raw[i : i + 1].isspace():
                i += 1
            seen += 1
        i += 1
        data = np.frombuffer(raw[i : i + w * h], dtype=np.uint8)
    else:
        raise ValueError(f"{path}: unsupported PGM magic {magic}")
    return data.reshape(h, w).astype(np.float64)


def write_pgm(path, img: np.ndarray) -> None:
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


class _Filter:
    """One filter's residual: the filter's dot product with a patch of
    one-pixel blocks (a float64 filter, copied once per device and dtype)."""

    def __init__(self, filt: np.ndarray):
        self.filt = torch.from_numpy(np.asarray(filt, dtype=np.float64))
        self._copies = {}

    def __call__(self, *pixels):
        patch = torch.cat(pixels)
        key = (patch.device, patch.dtype)
        filt = self._copies.get(key)
        if filt is None:
            filt = self._copies[key] = self.filt.to(*key)
        return (filt @ patch).reshape(1)


def build_problem(
    noisy: np.ndarray, foe: FieldsOfExperts, sigma: float = 20.0
) -> Tuple[Problem, np.ndarray]:
    """The MAP estimation problem (denoising.cc:150-190). Returns
    (problem, pixel ids (H, W))."""
    H, W = noisy.shape
    d = foe.size
    p = Problem()
    pix = p.add_parameter_blocks(noisy.reshape(-1, 1))
    pix2d = pix.reshape(H, W)

    # The data term sqrt(a) (x - b), a = 1/(2 sigma^2) (denoising.cc:156-166).
    sqrt_a = float(np.sqrt(1.0 / (2.0 * sigma * sigma)))

    def data_term(x, b):
        return sqrt_a * (x - b)

    p.add_residual_blocks(data_term, None, [pix], data=noisy.reshape(-1, 1))

    # One family per filter over all patches, the patch's pixels taken
    # column-major (fields_of_experts.cc's GetXYBlocks order).
    rr, cc = np.meshgrid(np.arange(H - d + 1), np.arange(W - d + 1), indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    patch_ids = [pix2d[rr + dr, cc + dc] for dc in range(d) for dr in range(d)]
    for fi in range(foe.num_filters):
        p.add_residual_blocks(
            _Filter(foe.filters[fi]), FieldsOfExpertsLoss(foe.alphas[fi]), patch_ids
        )
    return p, pix2d


def default_options() -> SolverOptions:
    """denoising.cc's flags: CGNR with JACOBI, eta 1e-2."""
    return SolverOptions(
        linear_solver_type=LinearSolverType.CGNR,
        preconditioner_type=PreconditionerType.JACOBI,
        eta=1e-2,
        max_num_iterations=100,
    )


def solution_image(problem: Problem, pix2d: np.ndarray) -> np.ndarray:
    """The pixels' current values as an (H, W) image."""
    offsets = problem.ambient_offsets()
    x = problem.state()
    return x[[offsets[int(p)] for p in pix2d.reshape(-1)]].reshape(pix2d.shape)
