"""A configuration's reference graph, built once per checkout and kept.

The graph is drawn from the configuration's ``graph_seed`` by the
frozen generators, with its haplotype paths and their truth, and built
by the program's own ``build`` command. The reference builds its own
index from the same PRG. Each build is kept under ``gpubench/cache/``
in a directory named by the configuration and a hash of everything
the build reads: the configuration file, the generators and, for the
program's build, the sources of its ``prg/``, ``index/``, ``native/``
and ``commands/build_command.py``; for the reference's, its sources.
"""
from __future__ import annotations

import hashlib
import multiprocessing as mp
import shutil
from pathlib import Path

import numpy as np

from . import generate
from .reference import quasimap as ref_quasimap

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "cache"
PROGRAM = "gramtools_tpu_torch"
PROGRAM_BUILD_SOURCES = ("prg", "index", "native", "commands/build_command.py")


def _files(base: Path, rels) -> list:
    out = []
    for rel in rels:
        p = base / rel
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob("*")
                              if f.is_file() and "__pycache__" not in f.parts))
        elif p.is_file():
            out.append(p)
    return out


def cache_key(config_path: Path, sources: list) -> str:
    h = hashlib.sha256()
    for f in [config_path, HERE / "generate.py"] + sources:
        h.update(str(f.relative_to(ROOT) if f.is_relative_to(ROOT)
                     else f.name).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


class Graph:
    """The files of one configuration's graph: ``prg`` (the PRG ints),
    ``ref_fa``, ``gram`` (the program's build), ``haplotypes`` (the
    paths and their truth) and ``ref_index`` (the reference's build)."""

    def __init__(self, config: dict, config_path: Path):
        self.config = config
        name = config["name"]
        prog_key = cache_key(config_path,
                             _files(ROOT / PROGRAM, PROGRAM_BUILD_SOURCES))
        ref_key = cache_key(config_path,
                            _files(HERE / "reference", ["."]))
        self.dir = CACHE / f"{name}-{prog_key}"
        self.ref_index = CACHE / f"{name}-reference-{ref_key}"
        self.prg = self.dir / "prg.bin"
        self.ref_fa = self.dir / "ref.fa"
        self.gram = self.dir / "gram"
        self.haplotypes = self.dir / "haplotypes.npz"

    def ready(self) -> bool:
        return (self.dir / "done").exists()

    def ref_ready(self) -> bool:
        return (self.ref_index / "done").exists()

    def ensure(self) -> bool:
        """Builds the graph and the program's index where missing; True
        where it built them."""
        if self.ready():
            return False
        self._build_program()
        return True

    def ensure_reference(self) -> bool:
        """Builds the reference's index where missing, in a process of
        its own; True where it built it."""
        if self.ref_ready():
            return False
        proc = mp.get_context("spawn").Process(
            target=_build_reference,
            args=(str(self.prg), self.config["kmer_size"],
                  str(self.ref_index)))
        proc.start()
        proc.join()
        if proc.exitcode != 0 or not self.ref_ready():
            raise RuntimeError("the reference's index build failed")
        return True

    def _build_program(self):
        from gramtools_tpu_torch.cli import run as cli
        from gramtools_tpu_torch.prg.linearise import PrgString

        c = self.config
        part = self.dir.with_name(self.dir.name + ".partial")
        shutil.rmtree(part, ignore_errors=True)
        part.mkdir(parents=True)
        ints, rng = generate.make_graph(c["profile"], c["genome_len"],
                                        c["num_sites"], c["graph_seed"],
                                        c["gc_share"])
        PrgString(ints).write(part / "prg.bin")
        (part / "ref.fa").write_text(
            ">ref\n" + generate.reference_sequence(ints) + "\n")
        paths, truth, spans = generate.sample_haplotypes(
            ints, rng, c["haplotypes"])
        np.savez(part / "haplotypes.npz", truth=truth, spans=spans,
                 **{f"path{i}": p for i, p in enumerate(paths)})
        if cli(["build", "--gram_dir", str(part / "gram"),
                "--prg", str(part / "prg.bin"), "--ref", str(part / "ref.fa"),
                "--kmer_size", str(c["kmer_size"]), "--force"]) != 0:
            raise RuntimeError("the program's build failed")
        (part / "done").write_text("")
        shutil.rmtree(self.dir, ignore_errors=True)
        part.rename(self.dir)

    def paths(self) -> "tuple[list, np.ndarray, np.ndarray]":
        with np.load(self.haplotypes) as z:
            n = self.config["haplotypes"]
            return ([z[f"path{i}"] for i in range(n)], z["truth"], z["spans"])


def _build_reference(prg: str, kmer_size: int, out: str):
    out = Path(out)
    part = out.with_name(out.name + ".partial")
    shutil.rmtree(part, ignore_errors=True)
    ref_quasimap.build_index(Path(prg), kmer_size, part)
    (part / "done").write_text("")
    shutil.rmtree(out, ignore_errors=True)
    part.rename(out)
