"""jVCF (JSON) output: whole-graph genotyping results, with multi-sample
combining.

Parity: libgramtools src/genotype/infer/output_specs/make_json.cpp,
json_prg_spec.cpp, json_site_spec.cpp; spec in fields.hpp:123-159.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..mapping.search import PrgIndex
from ..prg.markers import index_to_site_id, site_id_to_index
from .segment_tracker import SegmentTracker
from .types import GenotypedSite

SITE_FIELDS = {
    "POS": {"Desc": "Position on reference or pseudo-reference"},
    "SEG": {"Desc": "Segment ID"},
    "ALS": {"Desc": "Alleles at this site"},
    "HAPG": {"Desc": "Sample haplogroups of genotyped alleles"},
    "GT": {"Desc": "Genotype"},
    "DP": {"Desc": "Total read depth on variant site"},
    "COV": {"Desc": "Read coverage on each allele"},
    "FT": {"Desc": "Filters failed in a sample"},
}

FILTERS = {
    "AMBIG": {
        "Desc": "Ambiguous site. Different variant paths can produce "
                "the same sequence."
    }
}

MODEL_HEADERS = {
    "GT_CONF": "Genotype confidence as likelihood ratio of called and "
               "next most likely genotype.",
    "GT_CONF_PERCENTILE": "Percent of calls expected to have lower GT_CONF",
}


def make_json_site(site: GenotypedSite) -> dict:
    """make_json.cpp:61-83."""
    j: Dict = {
        "ALS": [a.sequence for a in site.alleles],
        "GT": [[None] if site.is_null() else list(site.genotype)],
        "HAPG": [list(site.haplogroups)],
        "DP": [site.total_coverage],
        "COV": [list(site.allele_covs)],
        "FT": [list(site.filters)],
        "GT_CONF": [site.gt_conf],
        "GT_CONF_PERCENTILE": [site.gt_conf_percentile],
    }
    return j


def make_json_prg(idx: PrgIndex, sites: List[GenotypedSite],
                  tracker: SegmentTracker, sample_id: str, desc: str) -> dict:
    """make_json.cpp:7-49."""
    g = idx.graph
    result = {
        "Model": "LevelGenotyping",
        "Site_Fields": SITE_FIELDS,
        "Filters": FILTERS,
        "Samples": [{"Name": sample_id, "Desc": desc}],
        "Sites": [],
        "Lvl1_Sites": [],
        "Child_Map": {},
    }
    if not g.is_nested:
        result["Lvl1_Sites"].append("all")
    else:
        for i in range(len(sites)):
            if index_to_site_id(i) not in g.par_map:
                result["Lvl1_Sites"].append(i)
        for parent, haplo_map in g.child_map().items():
            parent_index = str(site_id_to_index(parent))
            result["Child_Map"][parent_index] = {
                str(h): [site_id_to_index(c) for c in children]
                for h, children in haplo_map.items()
            }

    for site in sites:
        j = make_json_site(site)
        j["SEG"] = tracker.get_id(site.pos)
        j["POS"] = tracker.get_relative_pos(site.pos) + 1  # 1-based
        result["Sites"].append(j)
    return result


def write_json_prg(prg_json: dict, path):
    with open(path, "w") as fh:
        fh.write(json.dumps(prg_json, separators=(",", ":")))
        fh.write("\n")


# --- multi-sample combine (json_prg_spec.cpp:73-98, json_site_spec.cpp:110-135)

TRIVIALLY_MERGED = ["GT", "HAPG", "COV", "DP", "FT", "GT_CONF",
                    "GT_CONF_PERCENTILE"]
SINGLETON = ["POS", "SEG"]


class JSONCombineError(Exception):
    pass


def combine_json_prgs(first: dict, second: dict) -> dict:
    """Merge a second sample's jVCF into the first: allele-union re-indexing
    per site, per-sample appends for the merged entries."""
    for key in ("Model", "Lvl1_Sites", "Child_Map"):
        if first.get(key) != second.get(key):
            raise JSONCombineError(f"jVCFs differ on {key}")
    if len(first["Sites"]) != len(second["Sites"]):
        raise JSONCombineError("jVCFs have different site counts")

    result = json.loads(json.dumps(first))  # deep copy
    result["Samples"] = first["Samples"] + second["Samples"]
    for site_1, site_2 in zip(result["Sites"], second["Sites"]):
        combine_json_sites(site_1, site_2)
    return result


def combine_json_sites(site_1: dict, site_2: dict):
    """In-place merge of one site's per-sample entries
    (json_site_spec.cpp:110-135): allele union re-indexes GT, and COV
    vectors are rescaled onto the union allele list (absent alleles get
    coverage 0)."""
    for key in SINGLETON:
        if site_1.get(key) != site_2.get(key):
            raise JSONCombineError(f"sites differ on {key}")
    if site_1["ALS"][0] != site_2["ALS"][0]:
        raise JSONCombineError("sites differ on the REF allele")

    als = list(site_1["ALS"])
    index_of = {a: i for i, a in enumerate(als)}
    rebase = []
    for a in site_2["ALS"]:
        if a not in index_of:
            index_of[a] = len(als)
            als.append(a)
        rebase.append(index_of[a])
    site_1["ALS"] = als

    def rescale_cov(cov, mapping):
        out = [0] * len(als)
        for i, value in enumerate(cov):
            if i < len(mapping):
                out[mapping[i]] = value
        return out

    identity = list(range(len(als)))
    for key in TRIVIALLY_MERGED:
        if key not in site_1 or key not in site_2:
            continue
        if key == "GT":
            for sample_gt in site_2["GT"]:
                if sample_gt == [None] or sample_gt is None:
                    site_1["GT"].append(sample_gt)
                else:
                    site_1["GT"].append([rebase[g] for g in sample_gt])
        elif key == "COV":
            for c in site_2["COV"]:
                if len(c) != len(site_2["ALS"]):
                    raise JSONCombineError(
                        "COV and ALS of different cardinality")
            site_1["COV"] = [rescale_cov(c, identity) for c in site_1["COV"]]
            site_1["COV"] += [rescale_cov(c, rebase) for c in site_2["COV"]]
        else:
            site_1[key] = site_1[key] + site_2[key]
