"""PyTorch/CUDA port of the HIR compiler flow for NVIDIA Hopper.

Mirrors the layout of the JAX/Pallas reference package (``repro``) module by
module, so a reader finds the counterpart of each file under the same name:

  core/           the framework-free compiler core (IR, builder, verifier,
                  passes, cycle-accurate simulator, gallery) — an own copy
  core/lower/     ``lower_to_torch`` (functional lowering) and
                  ``lower_to_cuda`` (HIR -> generated CUDA C++ kernel)
  kernels/        hand-written CUDA kernels and their wrappers (``ops``)
  csrc/           the CUDA C++ sources, built with ``nvcc`` at first use
  configs/        model configurations (the reference's ten archs)
  models/         the language models (attention, MLA, MLP and MoE, SSD,
                  RG-LRU, transformer with encoder and cross-attention)
  train/          the train, prefill and decode step factories
  optim/          AdamW with a cosine schedule and global-norm clipping
  data/           the synthetic, seekable token stream (a copy)
  checkpoint/     atomic checkpoints in the reference's on-disk layout
  ft/             the checkpoint-restart driver (the reference's file)
  parallel/       the mesh over ``torch.distributed``: logical-axis sharding
                  rules, the int8 cross-pod gradient all-reduce
  launch/         ``serve``: the continuous-batching ``Engine``; ``train``:
                  the training driver; ``mesh``: the device meshes
  compat          carries a design, its stimulus and a model's parameters
                  over from the reference

Entry points take an explicit ``device=`` and default to the CUDA device;
they raise when there is none.  The CPU is used only on request.
"""

from ._device import resolve_device  # noqa: F401
