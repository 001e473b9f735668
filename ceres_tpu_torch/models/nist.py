"""NIST StRD nonlinear regression (port of ``ceres_tpu/models/nist.py``,
after ``examples/nist.cc``): parse a NIST ``.dat`` file, build one residual
block over all observations, solve from each start and score the
log-relative error (LRE) against the certified values (nist.cc:67-72).

The model formulas read their parameters as 1-element slices (``b[0:1]``),
which broadcast against the observations, so that no 0-dim scalar meets a
Python float under ``vmap(jacfwd)`` (see ``models/bal.py``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ceres_tpu_torch.problem import Problem
from ceres_tpu_torch.solver import SolverOptions, solve
from ceres_tpu_torch.types import LinearSolverType

PI = 3.141592653589793238462643383279


def _p(b, i):
    return b[i : i + 1]


# -- the models (examples/nist.cc:345-470) -----------------------------------


def _bennett5(b, x):
    return _p(b, 0) * (_p(b, 1) + x) ** (-1.0 / _p(b, 2))


def _boxbod(b, x):
    return _p(b, 0) * (1.0 - torch.exp(-_p(b, 1) * x))


def _chwirut(b, x):
    return torch.exp(-_p(b, 0) * x) / (_p(b, 1) + _p(b, 2) * x)


def _danwood(b, x):
    return _p(b, 0) * x ** _p(b, 1)


def _gauss(b, x):
    return (
        _p(b, 0) * torch.exp(-_p(b, 1) * x)
        + _p(b, 2) * torch.exp(-(((x - _p(b, 3)) / _p(b, 4)) ** 2))
        + _p(b, 5) * torch.exp(-(((x - _p(b, 6)) / _p(b, 7)) ** 2))
    )


def _lanczos(b, x):
    return (
        _p(b, 0) * torch.exp(-_p(b, 1) * x)
        + _p(b, 2) * torch.exp(-_p(b, 3) * x)
        + _p(b, 4) * torch.exp(-_p(b, 5) * x)
    )


def _hahn1(b, x):
    return (_p(b, 0) + _p(b, 1) * x + _p(b, 2) * x**2 + _p(b, 3) * x**3) / (
        1.0 + _p(b, 4) * x + _p(b, 5) * x**2 + _p(b, 6) * x**3
    )


def _kirby2(b, x):
    return (_p(b, 0) + _p(b, 1) * x + _p(b, 2) * x**2) / (
        1.0 + _p(b, 3) * x + _p(b, 4) * x**2
    )


def _mgh09(b, x):
    return _p(b, 0) * (x * x + x * _p(b, 1)) / (x * x + x * _p(b, 2) + _p(b, 3))


def _mgh10(b, x):
    return _p(b, 0) * torch.exp(_p(b, 1) / (x + _p(b, 2)))


def _mgh17(b, x):
    return _p(b, 0) + _p(b, 1) * torch.exp(-x * _p(b, 3)) + _p(b, 2) * torch.exp(-x * _p(b, 4))


def _misra1a(b, x):
    return _p(b, 0) * (1.0 - torch.exp(-_p(b, 1) * x))


def _misra1b(b, x):
    u = 1.0 + _p(b, 1) * x / 2.0
    return _p(b, 0) * (1.0 - 1.0 / (u * u))


def _misra1c(b, x):
    return _p(b, 0) * (1.0 - (1.0 + 2.0 * _p(b, 1) * x) ** (-0.5))


def _misra1d(b, x):
    return _p(b, 0) * _p(b, 1) * x / (1.0 + _p(b, 1) * x)


def _roszman1(b, x):
    return _p(b, 0) - _p(b, 1) * x - torch.atan2(_p(b, 2), x - _p(b, 3)) / PI


def _rat42(b, x):
    return _p(b, 0) / (1.0 + torch.exp(_p(b, 1) - _p(b, 2) * x))


def _rat43(b, x):
    return _p(b, 0) / (1.0 + torch.exp(_p(b, 1) - _p(b, 2) * x)) ** (1.0 / _p(b, 3))


def _thurber(b, x):
    return (_p(b, 0) + _p(b, 1) * x + _p(b, 2) * x**2 + _p(b, 3) * x**3) / (
        1.0 + _p(b, 4) * x + _p(b, 5) * x**2 + _p(b, 6) * x**3
    )


def _enso(b, x):
    w = 2.0 * PI * x
    return (
        _p(b, 0)
        + _p(b, 1) * torch.cos(w / 12.0)
        + _p(b, 2) * torch.sin(w / 12.0)
        + _p(b, 4) * torch.cos(w / _p(b, 3))
        + _p(b, 5) * torch.sin(w / _p(b, 3))
        + _p(b, 7) * torch.cos(w / _p(b, 6))
        + _p(b, 8) * torch.sin(w / _p(b, 6))
    )


def _eckerle4(b, x):
    return _p(b, 0) / _p(b, 1) * torch.exp(-0.5 * ((x - _p(b, 2)) / _p(b, 1)) ** 2)


def _nelson(b, x):
    # log(y) = b1 - b2*x1*exp(-b3*x2) (nist.cc Nelson; the response is log y).
    return _p(b, 0) - _p(b, 1) * x[..., 0] * torch.exp(-_p(b, 2) * x[..., 1])


MODELS: Dict[str, Callable] = {
    "Bennett5": _bennett5,
    "BoxBOD": _boxbod,
    "Chwirut1": _chwirut,
    "Chwirut2": _chwirut,
    "DanWood": _danwood,
    "Gauss1": _gauss,
    "Gauss2": _gauss,
    "Gauss3": _gauss,
    "Lanczos1": _lanczos,
    "Lanczos2": _lanczos,
    "Lanczos3": _lanczos,
    "Hahn1": _hahn1,
    "Kirby2": _kirby2,
    "MGH09": _mgh09,
    "MGH10": _mgh10,
    "MGH17": _mgh17,
    "Misra1a": _misra1a,
    "Misra1b": _misra1b,
    "Misra1c": _misra1c,
    "Misra1d": _misra1d,
    "Roszman1": _roszman1,
    "Rat42": _rat42,
    "Rat43": _rat43,
    "Thurber": _thurber,
    "ENSO": _enso,
    "Eckerle4": _eckerle4,
    "Nelson": _nelson,
}


@dataclasses.dataclass
class NISTProblem:
    name: str
    starts: np.ndarray  # (num_starts, num_params)
    certified: np.ndarray  # (num_params,)
    certified_cost: float  # 0.5 * residual sum of squares
    x: np.ndarray  # (num_obs,) or (num_obs, num_predictors)
    y: np.ndarray  # (num_obs,)
    model: Callable


def parse_nist_file(path) -> NISTProblem:
    """Parse one NIST .dat file (the layout logic of nist.cc NISTProblem)."""
    text = Path(path).read_text()
    lines = text.splitlines()
    name = re.search(r"Dataset Name:\s+(\S+)", text).group(1)

    def line_range(label):
        m = re.search(label + r"\s+\(lines\s+(\d+)\s+to\s+(\d+)\)", text)
        return int(m.group(1)), int(m.group(2))

    sv_lo, sv_hi = line_range("Starting Values")
    data_lo, data_hi = line_range("Data")
    n_response = int(re.search(r"(\d+)\s+Response", text).group(1))
    n_predictor = int(re.search(r"(\d+)\s+Predictor", text).group(1))
    rss = float(re.search(r"Residual Sum of Squares:\s+(\S+)", text).group(1))

    starts, certified = [], []
    for ln in lines[sv_lo - 1 : sv_hi]:
        # name  start...  certified  standard deviation
        vals = [float(t) for t in ln.replace("=", " ").split()[1:]]
        certified.append(vals[-2])
        starts.append(vals[:-2])
    data = np.asarray([[float(t) for t in ln.split()]
                       for ln in lines[data_lo - 1 : data_hi] if ln.split()])
    y = data[:, :n_response].reshape(-1)
    x = data[:, n_response : n_response + n_predictor]
    if n_predictor == 1:
        x = x.reshape(-1)
    if name == "Nelson":
        y = np.log(y)
    return NISTProblem(
        name=name,
        starts=np.asarray(starts).T,
        certified=np.asarray(certified),
        certified_cost=0.5 * rss,
        x=x,
        y=y,
        model=MODELS[name],
    )


def write_nist_file(path, name: str, starts: np.ndarray, certified: np.ndarray,
                    x: np.ndarray, y: np.ndarray) -> None:
    """Write a .dat file in the NIST StRD layout that
    :func:`parse_nist_file` reads: starts (num_starts, num_params), one
    predictor, the residual sum of squares at the certified values."""
    k = len(certified)
    rss = float(np.sum((y - MODELS[name](torch.from_numpy(np.asarray(certified, dtype=np.float64)),
                                        torch.from_numpy(np.asarray(x, dtype=np.float64))).numpy()) ** 2))
    sv_lo = 10
    data_lo = sv_lo + k + 3
    head = [
        "NIST/ITL StRD (written from given parameters)",
        f"Dataset Name:  {name}",
        "File Format:   ASCII",
        f"               Starting Values   (lines {sv_lo} to {sv_lo + k - 1})",
        f"               Data              (lines {data_lo} to {data_lo + len(y) - 1})",
        f"Model:         {k} Parameters",
        "               1 Response  (y)",
        "               1 Predictor (x)",
        "",
    ]
    params = [
        f"  b{i + 1} = " + "  ".join(repr(float(s)) for s in starts[:, i])
        + f"  {float(certified[i])!r}  0.0"
        for i in range(k)
    ]
    tail = [f"Residual Sum of Squares:  {rss!r}", "", "Data:   y   x"]  # 3 lines
    rows = [f"  {float(a)!r}  {float(b)!r}" for a, b in zip(y, x)]
    Path(path).write_text("\n".join(head + params + tail + rows) + "\n")


def build_problem(nist: NISTProblem, start_index: int) -> Problem:
    p = Problem()
    b = p.add_parameter_block(nist.starts[start_index].copy())
    model = nist.model

    def resid(bb, data):
        xx, yy = data
        return yy - model(bb, xx)

    p.add_residual_block(resid, None, [b], data=(nist.x, nist.y))
    return p


def lre(estimate: np.ndarray, certified: np.ndarray) -> float:
    """Log relative error, the least over the parameters, clamped to
    [0, 11] (nist.cc ComputeLRE)."""
    out = 11.0
    for e, c in zip(estimate, certified):
        if c == 0.0:
            v = -np.log10(abs(e)) if e != 0 else 11.0
        else:
            rel = abs(e - c) / abs(c)
            v = 11.0 if rel == 0 else -np.log10(rel)
        out = min(out, max(0.0, min(11.0, v)))
    return out


def default_options() -> SolverOptions:
    """nist.cc's flags: LM and DENSE_QR, 10000 iterations, tight
    tolerances, non-monotonic steps (so the host loop runs)."""
    return SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=10000,
        function_tolerance=1e-18,
        gradient_tolerance=1e-18,
        parameter_tolerance=1e-18,
        use_nonmonotonic_steps=True,
    )


def run_suite(
    data_dir,
    options: Optional[SolverOptions] = None,
    names: Optional[List[str]] = None,
    verbose: bool = False,
    device="cuda",
):
    """Solve every problem of ``data_dir`` from each start on ``device``
    (the card by default); returns a list of result dicts and, with
    ``verbose``, prints nist.cc's scoreboard."""
    results = []
    files = sorted(Path(data_dir).glob("*.dat"))
    if names:
        files = [f for f in files if f.stem in names]
    for f in files:
        nist = parse_nist_file(f)
        for si in range(nist.starts.shape[0]):
            prob = build_problem(nist, si)
            summary = solve(options or default_options(), prob, device=device)
            est = prob.parameter_block_value(0)
            score = lre(est, nist.certified)
            results.append(
                {
                    "name": nist.name,
                    "start": si,
                    "lre": score,
                    "final_cost": summary.final_cost,
                    "certified_cost": nist.certified_cost,
                    "iterations": len(summary.iterations),
                    "termination": str(summary.termination_type),
                }
            )
            if verbose:
                r = results[-1]
                print(
                    f"{r['name']:10s} start {si + 1}: LRE {score:5.2f}  "
                    f"cost {r['final_cost']:.10e} vs certified "
                    f"{r['certified_cost']:.10e}  ({r['iterations']} its)"
                )
    if results and verbose:
        avg = np.mean([r["lre"] for r in results])
        wins = sum(1 for r in results if r["lre"] >= 4.0)
        print(f"average LRE: {avg:.2f}; starts with LRE>=4: {wins}/{len(results)}")
    return results
