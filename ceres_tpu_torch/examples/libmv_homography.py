"""Homography estimation with symmetric geometric error — analog of
examples/libmv_homography.cc: algebraic (DLT-style) initialization, then
nonlinear refinement of the 8 free parameters (H[2,2] = 1) with a
TerminationCheckingCallback that stops once the average symmetric
distance reaches the expected precision."""

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt


def symmetric_geometric_residual(h, data):
    """4-vector [forward_error; backward_error]
    (libmv_homography.cc:111-134). h holds the 8 free entries; H22 = 1.
    """
    one = h.new_ones(1)
    x1, x2 = data[:2], data[2:]
    H = torch.cat([h, one]).reshape(3, 3)
    Hinv = torch.linalg.inv_ex(H).inverse  # no raise on a singular H, as in jnp
    X = torch.cat([x1, one])
    Y = torch.cat([x2, one])
    HX = H @ X
    HiY = Hinv @ Y
    HX = HX / HX[2:3]
    HiY = HiY / HiY[2:3]
    return torch.cat([HX[:2] - Y[:2], HiY[:2] - X[:2]])


def algebraic_init(x1, x2):
    """Homography2DFromCorrespondencesLinearEuc analog
    (libmv_homography.cc:148-240): DLT least squares for H with
    H[2,2] = 1."""
    n = x1.shape[0]
    L = np.zeros((2 * n, 8))
    b = np.zeros(2 * n)
    for i in range(n):
        x, y = x1[i]
        u, v = x2[i]
        L[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        b[2 * i] = u
        L[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i + 1] = v
    h, *_ = np.linalg.lstsq(L, b, rcond=None)
    return h


class TerminationCheckingCallback:
    """Stop when average symmetric distance is small enough
    (libmv_homography.cc:274-303)."""

    def __init__(self, problem, block, x1, x2, expected=1e-16):
        self.problem = problem
        self.block = block
        self.x1, self.x2 = x1, x2
        self.expected = expected

    def __call__(self, it):
        h = self.problem.parameter_block_value(self.block)
        H = np.append(h, 1.0).reshape(3, 3)
        Hinv = np.linalg.inv(H)
        total = 0.0
        for a, b in zip(self.x1, self.x2):
            X, Y = np.append(a, 1.0), np.append(b, 1.0)
            HX = H @ X
            HX /= HX[2]
            HiY = Hinv @ Y
            HiY /= HiY[2]
            total += np.sum((HX[:2] - Y[:2]) ** 2) + np.sum((HiY[:2] - X[:2]) ** 2)
        if total / len(self.x1) <= self.expected:
            return ctt.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ctt.CallbackReturnType.SOLVER_CONTINUE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_points", type=int, default=100)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    H_true = np.array(
        [[1.243715, -0.461057, -111.964454],
         [0.0, 0.617589, -192.379252],
         [0.0, -0.000983, 1.0]]
    )
    x1 = rng.uniform(0, 500, (args.num_points, 2))
    X = np.hstack([x1, np.ones((args.num_points, 1))]) @ H_true.T
    x2 = X[:, :2] / X[:, 2:3] + args.noise * rng.standard_normal((args.num_points, 2))

    h0 = algebraic_init(x1, x2)
    p = ctt.Problem()
    hb = p.add_parameter_block(h0)
    p.add_residual_blocks(
        symmetric_geometric_residual,
        None,
        [np.full(args.num_points, hb)],
        data=np.hstack([x1, x2]),
    )
    cb = TerminationCheckingCallback(p, hb, x1, x2)
    opts = ctt.SolverOptions(
        max_num_iterations=50,
        callbacks=[cb],
        update_state_every_iteration=True,
    )
    s = ctt.solve(opts, p, device=args.device)
    print(s.brief_report())
    H_est = np.append(p.parameter_block_value(hb), 1.0).reshape(3, 3)
    print("H (estimated, normalized):")
    print(np.round(H_est / H_est[2, 2], 6))
    print("H (truth):")
    print(H_true)


if __name__ == "__main__":
    main()
