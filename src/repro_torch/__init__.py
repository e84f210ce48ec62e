"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA Hopper card.

The package mirrors ``repro`` path for path and name for name: a module's
counterpart is found by swapping the package name. It imports ``torch``
only — nothing of JAX and nothing of ``repro`` — and keeps its own copy of
the host-side modules it needs (configs, scheduler, strip-mining
arithmetic).

Conventions:

- Plain functions on tensors over a dict-of-tensors parameter tree (the
  mirror of the reference's pytree), an explicit ``device`` argument and
  explicit ``torch.Generator``s.
- Every entry point defaults to ``device="cuda"`` and raises when no CUDA
  device is present; only an explicit ``device="cpu"`` runs on the CPU
  (see :mod:`repro_torch.device`).
- Kernels are hand-written CUDA C++ (``kernels/csrc``), built at first use
  by :mod:`repro_torch.kernels.build`. A wrapper takes its kernel's plain
  PyTorch version only for a tensor that lies on the CPU.
- float32 on the card means float32: the port leaves
  ``torch.backends.cuda.matmul.allow_tf32`` at its default ``False`` and
  never sets it, so fp32 matrix products do not run in TF32.
"""
