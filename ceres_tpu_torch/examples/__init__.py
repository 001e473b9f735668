"""The example programs of ``examples/`` on the port: one module per
program, with the same name, arguments and output, plus ``--device``
(``cuda`` by default; a solve on a machine without a card raises).

    python -m ceres_tpu_torch.examples.helloworld --device cpu

Residuals are written on one-element slices (``x[0:1]``), never on 0-dim
scalars, so that float32 tangents stay float32 under ``vmap(jacfwd)``; data
reaches a residual through the ``data=`` argument (moved with the problem
to its device) or is made on the residual's own device.
"""
