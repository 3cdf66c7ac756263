"""The user-facing examples of the port, one module each, run as

    python -m nonlinear_optimizer_for_slam_tpu_torch.examples.<name> [--device cuda|cpu]

Each is the JAX package's example of the same name (the repository's
``examples/``) on the port: the same ``main`` with its arguments and return
values (plus ``device``), printing the same lines. ``--device`` defaults to
``cuda`` and a missing GPU is an error; ``--device cpu`` runs the plain
PyTorch paths.
"""
