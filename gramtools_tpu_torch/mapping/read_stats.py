"""Read statistics: base error rate and per-site coverage depth.

Parity: libgramtools src/genotype/read_stats.cpp.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..common.seq import iter_fastx
from ..prg.markers import site_id_to_index
from .coverage import Coverage
from .search import PrgIndex

NUM_READS_USED = 10000  # include/genotype/read_stats.hpp:14


@dataclass
class ReadStats:
    mean_pb_error: float = 0.0
    num_bases_processed: int = 0
    no_qual_reads: int = 0
    max_read_length: int = 0
    mean_cov_depth: float = 0.0
    variance_cov_depth: float = 0.0
    num_sites_noCov: int = 0
    num_sites_total: int = 0

    # -- error rate (read_stats.cpp:21-70) ----------------------------------

    def compute_base_error_rate(self, reads_fpath):
        num_informative = 0
        no_qual = 0
        num_bases = 0
        running_qual = 0.0
        for _, seq, qual in iter_fastx(reads_fpath):
            if num_informative >= NUM_READS_USED:
                break
            self.max_read_length = max(self.max_read_length, len(seq))
            if not qual:
                no_qual += 1
                continue
            q = np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
            running_qual += float((q.astype(np.int64) - 33).sum())
            num_bases += q.size
            num_informative += 1
        if num_bases > 0:
            mean_qual = running_qual / num_bases
            self.mean_pb_error = 10 ** (-mean_qual / 10)
        self.num_bases_processed = num_bases
        self.no_qual_reads = no_qual

    # -- coverage depth (read_stats.cpp:72-160) ------------------------------

    def compute_coverage_depth(self, coverage: Coverage, idx: PrgIndex):
        site_coverages: List[float] = []
        num_sites_no_cov = 0
        g = idx.graph
        for entry, exit_ in g.bubbles:
            site_id = g.node(entry).site_id
            if site_id in g.par_map:
                continue  # nested sites not counted
            pb_cov, allele_cov = _extract_max_coverage_allele(
                coverage, idx, entry, exit_)
            if pb_cov:  # the exact integer sum, so np.mean's value
                site_pb_cov = sum(pb_cov) / len(pb_cov)
            else:  # direct-deletion allele
                site_pb_cov = float(allele_cov)
            site_coverages.append(site_pb_cov)
            if allele_cov == 0:
                num_sites_no_cov += 1
        if site_coverages:
            mean = float(np.mean(site_coverages))
            var = float(np.mean((np.asarray(site_coverages) - mean) ** 2))
        else:
            mean, var = 0.0, 0.0
        self.mean_cov_depth = mean
        self.variance_cov_depth = var
        self.num_sites_noCov = num_sites_no_cov
        self.num_sites_total = len(site_coverages)

    def serialise(self, path):
        data = {
            "Read_depth": {
                "Mean": self.mean_cov_depth,
                "Variance": self.variance_cov_depth,
                "num_sites_noCov": self.num_sites_noCov,
                "num_sites_total": self.num_sites_total,
            },
            "Max_read_length": self.max_read_length,
            "Quality": {
                "Error_rate_mean": self.mean_pb_error,
                "Num_bases": self.num_bases_processed,
                "No_qual_reads": self.no_qual_reads,
            },
        }
        with open(path, "w") as fh:
            json.dump(data, fh, indent=1)
            fh.write("\n")

    @classmethod
    def from_json(cls, path) -> "ReadStats":
        with open(path) as fh:
            d = json.load(fh)
        rs = cls()
        rs.mean_cov_depth = d["Read_depth"]["Mean"]
        rs.variance_cov_depth = d["Read_depth"]["Variance"]
        rs.num_sites_noCov = d["Read_depth"]["num_sites_noCov"]
        rs.num_sites_total = d["Read_depth"]["num_sites_total"]
        rs.max_read_length = d["Max_read_length"]
        rs.mean_pb_error = d["Quality"]["Error_rate_mean"]
        rs.num_bases_processed = d["Quality"]["Num_bases"]
        rs.no_qual_reads = d["Quality"]["No_qual_reads"]
        return rs


def _max_cov_haplogroup(gped_cov: Dict[Tuple[int, ...], int]) -> Tuple[int, int]:
    """read_stats.cpp:72-92: haplogroup with max summed coverage
    (ties -> lowest allele ID, as std::max_element keeps the first max)."""
    counts: Dict[int, int] = {}
    for group, count in gped_cov.items():
        for allele_id in group:
            counts[allele_id] = counts.get(allele_id, 0) + count
    if not counts:
        return (0, 0)
    best = max(sorted(counts.items()), key=lambda kv: kv[1])
    return best


def _extract_max_coverage_allele(coverage: Coverage, idx: PrgIndex,
                                 entry: int, exit_: int):
    """read_stats.cpp:94-117: walk the graph picking the max-coverage
    haplogroup at every bubble; returns (pb_cov, allele_cov) (the
    reference's allele sequence is not used here)."""
    g = idx.graph
    cur = entry
    site_index = site_id_to_index(g.node(cur).site_id)
    hapg, allele_cov = _max_cov_haplogroup(coverage.grouped_counts[site_index])
    cov_parts: List[int] = []
    while cur != exit_:
        node = g.node(cur)
        if node.is_bubble_start():
            site_index = site_id_to_index(node.site_id)
            h, _ = _max_cov_haplogroup(coverage.grouped_counts[site_index])
            cur = node.edges[h]
            continue
        if node.seq.size:
            cov_parts.extend(g.node_coverage(cur).tolist())
        cur = node.edges[0]
    return cov_parts, allele_cov
