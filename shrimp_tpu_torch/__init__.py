"""shrimp_tpu_torch — the PyTorch / CUDA port of shrimp-tpu for NVIDIA Hopper.

A second package beside `shrimp_tpu` (the JAX reference), and independent
of it: the host layers (codecs, seeds, index and its native C, FASTA/FASTQ
and SAM IO, MQV, option sets, host candidate generation, the colour-space
posterior, telemetry, the synthetic corpora) are the port's own copies,
changed only in their imports; the device programs are hand-written CUDA
kernels for `sm_90a`, each with a plain PyTorch version beside it.

Layer map (counterparts in `shrimp_tpu/`):
  ops.candidates_device  on-device candidate generation, L3
                         (kernels `csrc/candidates_device.cu`)
  ops.sw_vector      pass-1 vector SW, fused with the window gather, LS
                     and CS (kernel `csrc/sw_vector.cu`)
  ops.sw_gapless     gapless pass 1 (kernel `csrc/sw_gapless.cu`)
  ops.sw_full        pass-2 band-packed 3-state SW + traceback
                     (kernel `csrc/sw_full.cu`)
  ops.sw_full_cs     colour-space 4-layer pass 2 + traceback
                     (kernel `csrc/sw_full_cs.cu`)
  pipeline.mapper    the unpaired mapping funnel, letter and colour space
  gmapper            the gmapper CLI for that path

Which version runs is decided by where the tensors live: CPU tensors take
the plain PyTorch version, CUDA tensors take the kernel (or the call
raises).  The entry points (`Mapper`, `gmapper.main`) run on the card
unless the caller asks for the CPU.  This package imports neither jax nor
anything of `shrimp_tpu`.
"""

__version__ = "0.1.0"
