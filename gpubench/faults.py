"""The control and the planted faults that ``correct`` must catch.

None of these runs in a benchmark run. ``control.py`` plants one under
the timed path of a real cell on the card, and the CPU tests plant each
under the tiny rehearsal cell; ``correct`` has to come out false.

- ``control``: the configuration's guarantee of exact mapping broken in
  the way a faster program would be tempted to: the rows that the
  device cannot finish (unseeded, overflowed, flagged) are not re-mapped
  on the host, and go unrecorded.
- ``state_unchanged``: a buffer's completion returns without recording
  anything.
- ``half_batch``: half of every buffer left out.
- ``answer_altered``: in every buffer, the first selected allele that
  the device ships home is changed to another allele of its site.

A four-chip fault (the exchange between chips left out) has no cell to
plant it in: every cell runs on one card.
"""
from __future__ import annotations

import contextlib

FAULTS = ("control", "state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(name: str):
    from gramtools_tpu_torch.mapping import coverage_fast, engine, quasimap
    from gramtools_tpu_torch.mapping import search

    if name == "control":
        target, attr = search, "search_read_backwards"
        new = lambda *a, **kw: []
    elif name == "state_unchanged":
        target, attr = engine.LogBatchedEngine, "_record_complete_device"
        new = lambda self, *a, **kw: None
    elif name == "half_batch":
        target, attr = quasimap, "iter_read_buffers"
        orig_iter = quasimap.iter_read_buffers

        def new(*a, **kw):
            for buf in orig_iter(*a, **kw):
                half = len(buf) // 2
                yield (quasimap.ReadBatch(buf.mat[:half])
                       if isinstance(buf, quasimap.ReadBatch) else buf[:half])
    elif name == "answer_altered":
        target, attr = coverage_fast, "fold_loci_rows"
        orig_fold = coverage_fast.fold_loci_rows

        def new(coverage, loci_rows):
            if loci_rows.shape[0]:
                loci_rows = loci_rows.copy()
                loci_rows[0, 2] = 1 if loci_rows[0, 2] == 0 else 0
            return orig_fold(coverage, loci_rows)
    else:
        raise ValueError(f"no fault {name!r}: one of {', '.join(FAULTS)}")
    orig = getattr(target, attr)
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, orig)
