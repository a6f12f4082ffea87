"""The 2-bit packed read matrix (K6) as the scan kernels read it.

Port of gramtools_tpu/mapping/search_jax_log.py::_unpack_reads2. The
engine ships each buffer's reads as (ceil(steps/4), R) uint8, 4 bases a
byte along the step axis (code = base - 1), with each row's length; a
base past a row's body (row_len - k) is 0 (inactive). On the TPU the
fused program unpacks the whole matrix into (steps, R) int32 first (an
XLA function); here the scan kernels decode each base where they load it
(``csrc/scan_common.cuh``: ``Reads``, ``read_base``), so the unpacked
matrix is never written.

``PackedReads`` is a window of steps of that matrix, which the scan
kernels' wrappers (ops/wide_step.py, ops/locked_step.py) take in place
of int32 rows; slicing it along the step axis gives the window of a
run of phases. ``unpack_reads2`` is the plain version: the twins, on CPU
tensors, unpack a window with it and step through the rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

I32 = torch.int32


def unpack_reads2(reads_p: torch.Tensor, row_len: torch.Tensor, steps: int,
                  kmer_size: int) -> torch.Tensor:
    """2-bit packed read matrix -> (steps, SR) int32 base codes (port of
    _unpack_reads2). reads_p: (ceil(steps/4), SR) uint8, 4 bases a byte
    along the step axis (code = base - 1). Bases past a row's body
    (row_len - k) are 0 (= inactive), as in the zero-padded reads_T."""
    b = reads_p.to(I32)
    codes = torch.stack([(b >> (2 * j)) & 3 for j in range(4)], dim=1
                        ).reshape(4 * reads_p.shape[0], reads_p.shape[1])[:steps]
    n_steps_row = (row_len.to(I32) - kmer_size).clamp(0, steps)
    ar = torch.arange(steps, dtype=I32, device=reads_p.device)
    return torch.where(ar[:, None] < n_steps_row[None, :], codes + 1, 0)


@dataclass(frozen=True, eq=False)
class PackedReads:
    """Steps [start, stop) of a packed read matrix of ``steps`` steps:
    ``packed`` (ceil(steps/4), R) uint8, ``row_len`` (R,) int32."""

    packed: torch.Tensor
    row_len: torch.Tensor
    kmer_size: int
    steps: int
    start: int = 0
    stop: Optional[int] = None

    def __post_init__(self):
        if self.stop is None:
            object.__setattr__(self, "stop", self.steps)
        if not 0 <= self.start <= self.stop <= self.steps:
            raise ValueError(f"PackedReads: steps [{self.start}, "
                             f"{self.stop}) outside [0, {self.steps})")

    @property
    def shape(self):
        return (self.stop - self.start, self.packed.shape[1])

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def dim(self) -> int:
        return 2

    def contiguous(self) -> "PackedReads":
        return PackedReads(self.packed.contiguous(),
                           self.row_len.contiguous(), self.kmer_size,
                           self.steps, self.start, self.stop)

    def __getitem__(self, key) -> "PackedReads":
        """The window of steps ``key`` (a slice with step 1) of this one."""
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("PackedReads takes a slice of steps")
        a, b, _ = key.indices(self.stop - self.start)
        return PackedReads(self.packed, self.row_len, self.kmer_size,
                           self.steps, self.start + a,
                           self.start + max(a, b))

    def unpack(self) -> torch.Tensor:
        """The window's (stop - start, R) int32 bases (plain torch)."""
        return unpack_reads2(self.packed, self.row_len, self.steps,
                             self.kmer_size)[self.start:self.stop]


def as_rows(reads) -> torch.Tensor:
    """int32 base rows of ``reads``: a PackedReads window unpacked (the
    plain version), else the rows as they are."""
    return reads.unpack() if isinstance(reads, PackedReads) else reads
