"""gramtools_tpu_torch: the PyTorch/CUDA port of gramtools-tpu.

The JAX package ``gramtools_tpu`` is the reference; this package does
what it does -- ``build``, ``genotype``, ``discover``, ``simulate`` and
the tools -- with the device path on an NVIDIA GPU (written for the
H100), and is held bit-equal to it on the same inputs. It stands alone:
it imports nothing of ``gramtools_tpu`` and never ``jax``. The
reference's host modules (PRG, index, inference, coverage recording,
the host search oracle, the native C++ helpers) are carried here as
copies at the same relative paths; only code that touched JAX is
ported.

Ported so far: ``genotype --engine device`` with the fused device
recorder (the default) and the non-fused one
(``GRAMTOOLS_TPU_DEVICE_RECORD=0``), on one device, over a mesh of
devices and with a worker pool. The packed-rank LF gather
(``GRAMTOOLS_TPU_RANK=packed``), the genealogy replay and the whole
per-base coverage recorder run as hand-written CUDA kernels (``csrc/``).

Layering (bottom-up):
  common/    codecs, RNG, IO, timers and device trace, explicit device
             choice (GRAMTOOLS_TORCH_DEVICE), the measured workload
  prg/       linearised PRG + coverage graph (structure-of-arrays)
  index/     suffix array, FM/occ tables, kmer index, native helpers
  ops/       integer prefix sum; packed rank, replay and the per-base
             recorder (CUDA kernels + plain torch versions)
  mapping/   host search oracle, coverage recording, device index
             tables, scan steps, phase loop, fused recorder, engine,
             quasimap driver
  parallel/  mesh of devices, SA-range-sharded index, distributed init
  infer/     allele extraction, level genotyping model/runner, outputs
  commands/  build, genotype (with the torch engine), discover, simulate
  cli.py     gramtools-tpu-torch entry point; tools.py the tools
"""

__version__ = "0.1.0"
