"""p95 of the gaps between consecutive buffer completions over the
window, ms: the benchmark's spans around ``record_complete``. The count
of gaps goes to standard error."""
import statistics
import sys


def read(run):
    ends = sorted(t1 for name, _, _, t1 in run["spans"]
                  if name == "record_complete")
    gaps = [b - a for a, b in zip(ends, ends[1:])]
    if len(gaps) < 2:
        return None
    print(f"gpubench: buffer_gap_p95_ms over {len(gaps)} gaps",
          file=sys.stderr)
    return statistics.quantiles(gaps, n=20, method="inclusive")[18] * 1e3
