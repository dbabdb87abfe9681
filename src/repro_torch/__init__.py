"""PyTorch/CUDA port of the EULER-ADAS reproduction.

A second package beside the JAX reference (``repro``), with the same layout
and names: ``core`` (posit codec, ILM planes, engine), ``kernels`` (CUDA C++
kernels for Hopper with plain PyTorch versions beside them), ``numerics``
(policies and backends), ``models``, ``configs``, ``serving``,
``training``, ``optim``, ``data``, ``distributed`` and ``launch``.  It
imports ``torch`` and never ``jax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
kernel wrapper dispatches on the device of the tensor it is given: a CPU
tensor runs the kernel's plain PyTorch version, a CUDA tensor launches the
kernel (or raises).
"""
