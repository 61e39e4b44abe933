"""Whole `find` jobs over the cell's reference, with the graph made from
the donor without counting (`"graph": "donor"`: `find -graph`) or built
from the reads in the job (`"graph": "reads"`: `find -in`).

Traffic keys: `graph`, `args` (options added to every job's command),
`warmup_bases` (the warm-up job's cut of the genome). The detection
options come from the configuration (`OPTIONS`), which the program's
command and the reference both read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mtgbench import compare as C
from mtgbench import gen
from mtgbench.reference import count as RC
from mtgbench.reference import find as RF
from mtgbench.reference import words as W

LIMIT = 0  # outputs are compared exactly
# the configuration's keys passed to every job as `find` options
OPTIONS = {"max_rep": "-max-rep", "het_max_occ": "-het-max-occ", "snp_min_val": "-snp-min-val",
           "branching_filter": "-branching-filter"}


class Job:
    """A job kind's interface to the harness: the inputs made in
    `workdir` from the seed; `work` (units of one job, which the rates
    read), `kernel_inputs` (what the kernels' yardsticks read);
    `warmup_args` and `args` (a job's command, writing to `prefix`);
    `reference()`, `check(prefixes, want)` ({name: (number, limit)}) and
    `write_answer` (the control's way into the program's place)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, workdir: str, device: str):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.k = int(cfg["kmer_size"])
        self.from_reads = traffic["graph"] == "reads"
        self.ref, self.donor, _ins = gen.case_from_config(cfg, seed)
        self.seq = gen.NUC[self.ref].tobytes().decode()
        self.layout = gen.ReadLayout(self.donor.size, cfg, seed + 1)
        self.ref_path = self._inputs(workdir, "main", self.ref, self.donor, self.layout)
        cut = int(traffic["warmup_bases"])
        small = gen.ReadLayout(cut, cfg, seed + 2)
        self.warmup_path = self._inputs(workdir, "warmup", self.ref[:cut], self.donor[:cut], small)
        self.work = {"ref_bp": int(self.ref.size)}
        if self.from_reads:
            self.work["read_bp"] = int(2 * self.layout.n_frag * self.layout.read_len)
        self.kernel_inputs = {"ref_bp": int(self.ref.size), "k": self.k}

    def _inputs(self, workdir: str, name: str, ref, donor, layout) -> dict:
        d = os.path.join(workdir, name)
        os.makedirs(d, exist_ok=True)
        paths = {"ref": os.path.join(d, "ref.fa")}
        gen.write_fasta(paths["ref"], gen.CHROM, ref)
        if self.from_reads:
            paths["in"] = gen.write_fastq(os.path.join(d, "r"), layout, donor)
        else:
            paths["graph"] = os.path.join(d, "g.h5")
            ab_min = int(self.cfg["graph_abundance_min"])
            graph = gen.donor_graph(donor, layout, self.k, ab_min, self.device)
            gen.write_graph(paths["graph"], self.k, *graph, ab_min)
            if name == "main":
                self.graph = graph  # the reference's solid set
        return paths

    def _args(self, paths: dict, prefix: str) -> list[str]:
        args = ["find", "-ref", paths["ref"], "-out", prefix, "-profile"]
        if self.from_reads:
            args += ["-in", paths["in"], "-kmer-size", str(self.k),
                     "-abundance-min", str(self.cfg["abundance_min"])]
        else:
            args += ["-graph", paths["graph"]]
        for key, option in OPTIONS.items():
            args += [option, str(self.cfg[key])]
        args += list(self.traffic.get("args", []))
        if self.device == "cpu":
            args += ["-device", "cpu"]
        return args

    def warmup_args(self, prefix: str) -> list[str]:
        return self._args(self.warmup_path, prefix)

    def args(self, prefix: str) -> list[str]:
        return self._args(self.ref_path, prefix)

    # -- the comparison ------------------------------------------------------
    def reference(self, member=None) -> dict:
        """What every job's outputs must hold. `member` (the control's)
        wraps the solid set the scan queries."""
        k = self.k
        want: dict = {}
        if self.from_reads:
            keys, counts = RC.count_reads(gen.reads(self.layout, self.donor), k, self.device)
            ab_min = self.cfg["abundance_min"]
            cutoff = RC.auto_cutoff(RC.histogram(counts)) if ab_min == "auto" else int(ab_min)
            keep = counts >= cutoff
            keys, counts = keys[keep], counts[keep]
            want["graph"] = (keys, counts, {"kmers_nb_solid": int(keys.size), "thresholds": cutoff,
                                            "nb_branching": RC.nb_branching(keys, k, self.device)})
            solid = W.KeySet(np.zeros_like(keys), keys, k, counts)
        else:
            hi, lo, counts = self.graph
            solid = W.KeySet(hi, lo, k, counts)
        if member is not None:
            solid = member(solid)
        want["bkpt"], want["vcf"] = RF.find(self.ref, gen.CHROM, self.seq, solid, k, self.cfg, self.device)
        return want

    def write_answer(self, want: dict, prefix: str):
        """Write a reference's answer as a job's output files (the control
        takes the program's place this way)."""
        with open(prefix + ".breakpoints", "w") as f:
            f.write(want["bkpt"])
        with open(prefix + ".othervariants.vcf", "w") as f:
            f.write(want["vcf"])
        if "graph" in want:
            keys, counts, info = want["graph"]
            np.savez(prefix + ".h5.npz", kmers=keys, counts=counts,
                     info=np.frombuffer(json.dumps(info).encode(), np.uint8))
            os.replace(prefix + ".h5.npz", prefix + ".h5")

    def check(self, prefixes: list[str], want: dict) -> dict[str, tuple[int, int]]:
        bkpt = C.text_lines(want["bkpt"])
        vcf = C.text_lines(want["vcf"])
        off = {"bkpt_lines_off": 0, "vcf_lines_off": 0}
        if self.from_reads:
            off.update(graph_kmers_off=0, graph_counts_off=0, graph_info_off=0)
        for p in prefixes:
            off["bkpt_lines_off"] += C.lines_off(C.read_lines(p + ".breakpoints"), bkpt)
            got = C.read_lines(p + ".othervariants.vcf", "#")
            off["vcf_lines_off"] += C.lines_off(got, vcf)
            if self.from_reads:
                for name, n in C.graph_off(p + ".h5", *want["graph"]).items():
                    off[f"graph_{name}_off"] += n
        return {name: (n, LIMIT) for name, n in off.items()}
