"""`fill` module orchestration (the reference Filler tool, src/Filler.cpp).

Both modes:
- breakpoint mode (-bkpt): pairs of FASTA records (left/right anchor kmers)
  from `find`; outputs .insertions.fasta, .insertions.vcf, .info.txt;
- contig mode (-contig): gap-fills between contig extremities; outputs
  .insertions.fasta, .gfa, .info.txt, and <out>_seed_dictionary.fasta.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import MTG_COMPAT_VERSION, KSIZE_STRING
from ..device import resolve_device
from ..graph import dbg
from ..io.bank import Bank
from ..ops import kmers as K
from ..parallel import distributed as D
from ..utils import dna, stdcompat
from ..utils.progress import Progress
from ..utils.properties import Properties
from .contig_graph import ContigGraph
from .traversal import (
    GraphView,
    TraversalPolicy,
    construct_linear_seqs_co,
    drive,
    host_walk,
)
from .types import FilledInsertion, InfoNode, median, remove_almost_identical_solutions

U64 = (1 << 64) - 1

_DEVICE_ENGINES = ("device", "device-qb")


class FillerError(Exception):
    pass


# fork-inherited state for the process-pool dispatcher (file handles are
# never touched in workers; computation only)
_PARALLEL_FILLER = None
_PARALLEL_METHOD = None


def _parallel_worker(*args):
    return getattr(_PARALLEL_FILLER, _PARALLEL_METHOD)(*args)


def find_nodes_containing_multiple_r(k, target_dict, contigs, nb_mis_allowed):
    """Approximate search of every target anchor inside every contig
    (src/Filler.cpp:1294-1378), vectorized.

    Per node, replays the reference scan order exactly — positions ascending,
    targets in dictionary order, strict best-match improvement, early stop on
    an exact hit — and keeps one best (position, target) per node. identNT
    semantics: case-tolerant equality, node-side 'N' never matches.
    """
    terminal_nodes: list[InfoNode] = []
    anchors = list(target_dict.items())
    if not anchors:
        return terminal_nodes
    A = np.stack([np.frombuffer(a.encode("ascii"), dtype=np.uint8) for a, _ in anchors])
    ids = [ide for _, ide in anchors]
    thresh = k - nb_mis_allowed
    for node_nb, nodeseq in enumerate(contigs):
        if len(nodeseq) < k:
            sys.stdout.write("Too short\n")
            continue
        nbytes = np.frombuffer(nodeseq.encode("ascii"), dtype=np.uint8)
        W = np.lib.stride_tricks.sliding_window_view(nbytes, k)  # (P, k)
        diff = np.abs(W[:, None, :].astype(np.int16) - A[None, :, :].astype(np.int16))
        match = ((diff == 0) | (diff == 32)) & (W[:, None, :] != ord("N"))
        counts = match.sum(axis=2)  # (P, T)
        cmax = int(counts.max()) if counts.size else 0
        if cmax < thresh or cmax == 0:
            continue
        if cmax == k:
            # early-stop semantics: first position with a full match wins
            rows = np.nonzero((counts == k).any(axis=1))[0]
            j = int(rows[0])
            a = int(np.nonzero(counts[j] == k)[0][0])
            best = k
        else:
            rows = np.nonzero((counts == cmax).any(axis=1))[0]
            j = int(rows[0])
            a = int(np.nonzero(counts[j] == cmax)[0][0])
            best = cmax
        terminal_nodes.append(InfoNode(node_nb, j, k - best, ids[a]))
    return terminal_nodes


def _atoi(s: str) -> int:
    """C atoi: parse optional leading integer, 0 on failure."""
    s2 = s.lstrip()
    i = 0
    if i < len(s2) and s2[i] in "+-":
        i += 1
    j = i
    while j < len(s2) and s2[j].isdigit():
        j += 1
    if j == i or (j == i + 1 and not s2[i].isdigit()):
        return 0
    try:
        return int(s2[:j])
    except ValueError:
        return 0


class Filler:
    def __init__(self, opts: dict, out=None):
        self.opts = opts
        self.out = out or sys.stdout
        self.nb_mis_allowed = 2
        self.nb_gap_allowed = 0
        self.nb_breakpoints = 0
        self.nb_filled_breakpoints = 0
        self.nb_multiple_fill = 0
        self.nb_contigs = 0
        self.nb_used_contigs = 0
        self.policy = TraversalPolicy()

    # ------------------------------------------------------------------
    def execute(self):
        opts = self.opts
        has_graph = bool(opts.get("graph"))
        has_in = bool(opts.get("in"))
        if has_graph == has_in:
            raise FillerError(
                "options -graph and -in are incompatible, but at least one of these is mandatory"
            )
        has_bkpt = bool(opts.get("bkpt"))
        has_contig = bool(opts.get("contig"))
        if has_bkpt == has_contig:
            raise FillerError(
                "option -bkpt and -contig are incompatible, but at least one of these is mandatory"
            )
        if not opts.get("out"):
            opts["out"] = "MindTheGap_Expe-" + time.strftime("%Y-%m-%d.%I:%M")
        prefix = opts["out"]

        from ..utils.phases import PhaseTimer

        self.phases = PhaseTimer()
        self.fill_engine = str(opts.get("fill-engine", "auto"))
        count_engine = str(opts.get("count-engine", "auto"))
        # the device is resolved only for a device engine: the default fill
        # runs on the host alone
        self.device = None
        if self.fill_engine in _DEVICE_ENGINES or (has_in and count_engine == "device"):
            self.device = resolve_device(opts.get("device"))
        with self.phases.active(opts.get("profile-trace"), self.device):
            t0 = time.time()
            if has_in:
              with self.phases.phase("graph build"):
                self.graph = dbg.build_graph(
                    opts["in"],
                    int(opts.get("kmer-size", 31)),
                    opts.get("abundance-min", "auto"),
                    int(opts.get("abundance-max", 2147483647)),
                    count_engine=count_engine,
                    max_memory_mb=int(opts.get("max-memory", 2000)),
                    max_disk_mb=int(opts.get("max-disk", 0)),
                    tmp_prefix=str(opts.get("out-tmp", ".")) or None,
                    device=self.device,
                )
            else:
              with self.phases.phase("graph load"):
                sys.stderr.write("Loading the graph...")
                self.graph = dbg.Graph.load(opts["graph"])
                sys.stderr.write("done\n")
            self.k = self.graph.k
            with self.phases.phase("graph view (quotient map) build"):
                layout = "bucket" if self.fill_engine == "device-qb" else "cuckoo"
                self.view = GraphView(self.graph, layout=layout)
            if self.fill_engine in ("auto", "native"):
                # C++ per-job engine (native/traversal.cpp): whole
                # construct_linear_seqs jobs run native, everything else
                # (anchor matching, contig graph, dedup, writers) unchanged
                if not self.view.enable_native(self.policy) and self.fill_engine == "native":
                    sys.stderr.write(
                        "Warning: -fill-engine native unavailable (needs g++ and kmer-size <= 32); using host\n"
                    )

            self.breakpoint_mode = has_bkpt
            self.verbose = int(opts.get("verbose", 1))
            self.nb_cores = int(opts.get("nb-cores", 0))
            self.max_depth = int(opts.get("max-length", 10000))
            self.max_nodes = int(opts.get("max-nodes", 100))
            self.contig_trim_size = int(opts.get("overlap", 0))
            if self.contig_trim_size == 0:
                self.contig_trim_size = self.k
            if self.contig_trim_size < self.k:
                self.contig_trim_size = self.k
                sys.stderr.write(
                    "Warning :  the contig overlap parameter should be greater or equal to kmer size, "
                    f"setting it to {self.k}\n"
                )
            self.filter = bool(opts.get("filter"))
            self.fwd_only = bool(opts.get("fwd-only"))
            self.extend = bool(opts.get("extend"))

            self.insert_file_name = prefix + ".insertions.fasta"
            self.insert_file = open(self.insert_file_name, "w")
            self.insert_info_file_name = prefix + ".info.txt"
            self.insert_info_file = open(self.insert_info_file_name, "w")
            self.vcf_file = None
            self.gfa_file = None
            self.extension_file = None
            if self.breakpoint_mode:
                self.vcf_file_name = prefix + ".insertions.vcf"
                self.vcf_file = open(self.vcf_file_name, "w")
                self._write_vcf_header()
            else:
                self.gfa_file_name = prefix + ".gfa"
                self.gfa_file = open(self.gfa_file_name, "w")
            if self.extend:
                self.extension_file_name = prefix + ".extensions.fasta"
                self.extension_file = open(self.extension_file_name, "w")

            bank_uri = opts["bkpt"] if self.breakpoint_mode else opts["contig"]
            self.breakpoint_bank = Bank.open(bank_uri)

            with self.phases.phase("fill jobs"):
                if self.breakpoint_mode:
                    self._fill_breakpoints()
                else:
                    self._fill_contigs()

            self.insert_file.close()
            self.insert_info_file.close()
            if self.vcf_file:
                self.vcf_file.close()
            if self.gfa_file:
                self.gfa_file.close()
            if self.extension_file:
                self.extension_file.close()

            seconds = time.time() - t0
        info = self._resume(seconds)
        self.out.write(info.dump())
        return info

    # ------------------------------------------------------------------
    # bkpt mode (breakpointFunctor, src/Filler.cpp:615-739)
    # ------------------------------------------------------------------
    def _bkpt_job(self, prev, rec):
        """Compute one breakpoint job; returns everything the writers need.
        Pure with respect to output files (parallel-safe)."""
        return drive(self._bkpt_job_co(prev, rec), lambda n, b: host_walk(self.view, n, b))

    def _bkpt_job_co(self, prev, rec):
        """Coroutine form of _bkpt_job (yields walk requests for batching)."""
        source_seq = prev.seq
        breakpoint_name = prev.comment_short
        begin_kmer_repeated = "REPEATED" in prev.comment
        target_seq = rec.seq
        breakpoint_name_r = rec.comment_short
        end_kmer_repeated = "REPEATED" in rec.comment
        is_anchor_repeated = begin_kmer_repeated or end_kmer_repeated

        filled: list[FilledInsertion] = []
        target_dict = {target_seq: (breakpoint_name_r, False)}
        infostring = [""]
        extension_seq = [""]
        yield from self.gap_fill_from_source_co(
            infostring, source_seq, target_seq, filled, target_dict,
            is_anchor_repeated, False, extension_seq,
        )

        extension_seq_rev = [""]
        if not self.fwd_only and len(filled) == 0:
            target_seq2 = dna.revcomp(source_seq)
            target_dict = {target_seq2: (breakpoint_name, False)}
            source_seq2 = dna.revcomp(target_seq)
            breakpoint_name = breakpoint_name_r
            yield from self.gap_fill_from_source_co(
                infostring, source_seq2, target_seq2, filled, target_dict,
                is_anchor_repeated, True, extension_seq_rev,
            )
        return (filled, breakpoint_name, infostring[0], source_seq, target_seq,
                extension_seq[0], extension_seq_rev[0])

    def _write_bkpt_result(self, result):
        (filled, breakpoint_name, info, source_seq, target_seq, ext, ext_rev) = result
        self.write_filled_breakpoint(filled, breakpoint_name, info)
        self.write_vcf(filled, breakpoint_name, source_seq)
        if len(filled) == 0 and self.extend:
            self.write_extensions(ext, breakpoint_name, source_seq)
            self.write_extensions(ext_rev, breakpoint_name + "_reverse", dna.revcomp(target_seq))
        self.nb_breakpoints += 1

    def _fill_breakpoints(self):
        pairs = []
        prev = None
        for rec in self.breakpoint_bank:
            if (rec.index & 1) == 0:
                prev = rec
            else:
                pairs.append((prev, rec))
        progress = Progress(len(pairs), "Filling the breakpoints", enabled=self.verbose > 0)
        for result in self._run_jobs(self._bkpt_job, self._bkpt_job_co, pairs):
            self._write_bkpt_result(result)
            progress.inc()
        progress.finish()

    # ------------------------------------------------------------------
    # job dispatch: host process pool (the GATB Dispatcher analog) or the
    # device-batched walker (jobs ride lanes; fill/walk_device.py): the u64
    # walker for k <= 32, the span walker for 32 < k <= 256 (both device
    # engines take it there, as in the JAX package). At k <= 32 the walk
    # lanes ride the device mesh of the process when it has more than one
    # device (its largest power of two).
    # ------------------------------------------------------------------
    def _run_jobs(self, fn, co_fn, jobs):
        # across processes: shard the jobs over the ranks (the Dispatcher
        # fan-out at host scale), gather every rank's results and replay
        # them in input order, so that every rank writes the same artifacts;
        # rank 0 is the writer of record
        nproc = D.process_count()
        if nproc > 1:
            lo, hi = D.shard_bounds(len(jobs), nproc, D.process_index())
            # no fork pool in a distributed process: the process group's
            # threads (and CUDA's state) do not survive a fork
            saved_cores, self.nb_cores = self.nb_cores, 1
            try:
                local = list(self._run_jobs_local(fn, co_fn, jobs[lo:hi]))
            finally:
                self.nb_cores = saved_cores
            self.n_local_jobs = len(local)
            for chunk in D.allgather_object(local):
                yield from chunk
            return
        yield from self._run_jobs_local(fn, co_fn, jobs)

    def _run_jobs_local(self, fn, co_fn, jobs):
        engine = self.fill_engine
        if engine == "device-qb":
            engine = "device"  # same dispatch; the view/walker carry the layout
        if engine == "device" and self.view.qm is None and self.k > 256:
            sys.stderr.write("Warning: -fill-engine device requires kmer-size <= 256; using host\n")
            engine = "host"
        if engine == "device":
            from .walk_device import BatchWalker, run_jobs_batched

            mesh = None
            # k <= 32: u64 lanes, over the mesh if there is one; across
            # processes each rank walks its jobs on its own device
            if self.view.qm is not None and D.process_count() == 1:
                from ..parallel.mesh import make_mesh, pow2_mesh

                devices = make_mesh(self.device)
                mesh = pow2_mesh(devices) if len(devices) > 1 else None
            qmap = self.view.qm if self.view.qm is not None else self.view.ensure_span_map()
            walker = BatchWalker(qmap, self.k, self.device, mesh=mesh)
            gens = [co_fn(*j) for j in jobs]
            yield from run_jobs_batched(gens, walker)
        else:
            yield from self._parallel_map(fn, jobs)

    # ------------------------------------------------------------------
    # host-parallel dispatcher (the GATB Dispatcher equivalent, reference
    # src/Filler.cpp:824,844): jobs fan out over a process pool, results are
    # written back in input order — deterministic, unlike the reference's
    # flockfile interleaving (its CI pins -nb-cores 1 for the same reason)
    # ------------------------------------------------------------------
    def _parallel_map(self, fn, jobs):
        n_cores = self.nb_cores or (os.cpu_count() or 1)
        if n_cores <= 1 or len(jobs) < 2:
            for j in jobs:
                yield fn(*j)
            return
        import multiprocessing as mp

        global _PARALLEL_FILLER, _PARALLEL_METHOD
        _PARALLEL_FILLER = self
        _PARALLEL_METHOD = fn.__name__
        ctx = mp.get_context("fork")  # workers inherit the graph copy-on-write
        try:
            with ctx.Pool(min(n_cores, len(jobs))) as pool:
                results = pool.starmap(
                    _parallel_worker, jobs,
                    chunksize=max(1, len(jobs) // (4 * n_cores)),
                )
        finally:
            _PARALLEL_FILLER = None
        yield from results

    # ------------------------------------------------------------------
    # contig mode (fillAny contig branch + contigFunctor,
    # src/Filler.cpp:484-612, 755-829)
    # ------------------------------------------------------------------
    def _fill_contigs(self):
        k = self.k
        overlap = self.contig_trim_size
        prefix = self.opts["out"]
        seed_records: list[tuple[str, str]] = []
        all_target_dict: dict[str, tuple[str, bool]] = {}

        seed_file = open(prefix + "_seed_dictionary.fasta", "w")
        for rec in self.breakpoint_bank:
            contig_seq = rec.seq
            self.nb_contigs += 1
            self.gfa_file.write("S\t%s\t%s\n" % (rec.comment_short, contig_seq))
            if len(contig_seq) > 2 * overlap + k:
                seed_f = contig_seq[len(contig_seq) - (overlap + k) : len(contig_seq) - (overlap + k) + k]
                name = rec.comment_short
                target_f = contig_seq[overlap : overlap + k]
                contig_rc = dna.revcomp(contig_seq)
                seed_rc = contig_rc[len(contig_rc) - (overlap + k) : len(contig_rc) - (overlap + k) + k]
                target_rc = contig_rc[overlap : overlap + k]
                all_target_dict.setdefault(target_f, (name, False))
                all_target_dict.setdefault(target_rc, (name, True))
                seed_file.write(">%s\n%s\n>%s_Rc\n%s\n" % (name, seed_f, name, seed_rc))
                seed_records.append((name, seed_f))
                seed_records.append((name + "_Rc", seed_rc))
                self.nb_used_contigs += 1
            else:
                limit = 2 * overlap + k
                sys.stderr.write(
                    "Warning contig not used (too short: <= 2 x overlap + kmerSize = %i nt): %s of size %i nt\n"
                    % (limit, rec.comment_short, len(contig_seq))
                )
        seed_file.close()

        self._all_target_dict = all_target_dict
        progress = Progress(len(seed_records), "Filling the contigs", enabled=self.verbose > 0)
        for result in self._run_jobs(self._contig_job, self._contig_job_co, seed_records):
            self._write_contig_result(result)
            progress.inc()
        progress.finish()

    def _contig_job(self, seed_name: str, source_seq: str):
        return drive(
            self._contig_job_co(seed_name, source_seq),
            lambda n, b: host_walk(self.view, n, b),
        )

    def _contig_job_co(self, seed_name: str, source_seq: str):
        all_target_dict = self._all_target_dict
        is_rc = len(seed_name) >= 3 and seed_name.endswith("_Rc")

        conc_target = []
        target_dict: dict[str, tuple[str, bool]] = {}
        for tseq, (tname, t_is_rc) in all_target_dict.items():
            temp_name = tname + "_Rc" if t_is_rc else tname
            if temp_name != seed_name:  # avoid looping on the same contig
                conc_target.append(tseq)
                target_dict[tseq] = (tname, t_is_rc)
        conc_target_seq = "".join(conc_target)

        filled: list[FilledInsertion] = []
        infostring = [""]
        extension_seq = [""]
        yield from self.gap_fill_from_source_co(
            infostring, source_seq, conc_target_seq, filled, target_dict,
            False, False, extension_seq,
        )

        # filter out loops (target == seed_Rc)
        kept = []
        for f in filled:
            tname, t_is_rc = f.target_id
            rev_target_name = tname if t_is_rc else tname + "_Rc"
            if rev_target_name != seed_name:
                kept.append(f)
        filled = kept
        return filled, seed_name, source_seq, is_rc, infostring[0], extension_seq[0]

    def _write_contig_result(self, result):
        filled, seed_name, source_seq, is_rc, info, ext = result
        self.write_filled_breakpoint(filled, seed_name, info)
        self.write_to_gfa(filled, source_seq, seed_name, is_rc)
        if len(filled) == 0 and self.extend:
            self.write_extensions(ext, seed_name, source_seq)
        self.nb_breakpoints += 1

    # ------------------------------------------------------------------
    # one gap-fill job (gapFillFromSource, src/Filler.cpp:854-1026)
    # ------------------------------------------------------------------
    def gap_fill_from_source(
        self, infostring, source_seq, target_seq, filled, target_dict,
        is_anchor_repeated, reverse, extension_out,
    ):
        return drive(
            self.gap_fill_from_source_co(
                infostring, source_seq, target_seq, filled, target_dict,
                is_anchor_repeated, reverse, extension_out,
            ),
            lambda n, b: host_walk(self.view, n, b),
        )

    def gap_fill_from_source_co(
        self, infostring, source_seq, target_seq, filled, target_dict,
        is_anchor_repeated, reverse, extension_out,
    ):
        nb_mis_allowed = 0 if is_anchor_repeated else self.nb_mis_allowed

        contigs = yield from construct_linear_seqs_co(
            self.graph, source_seq, target_seq, self.max_depth, self.max_nodes,
            swf=True, policy=self.policy, view=self.view,
        )
        nb_nodes = len(contigs)
        totalnt = sum(len(c) for c in contigs)
        infostring[0] += "\t%i\t%i" % (nb_nodes, totalnt)

        cgraph = ContigGraph(contigs, self.k)
        terminal_nodes = self.find_nodes_containing_multiple_r(target_dict, contigs, nb_mis_allowed)

        infostring[0] += "\t%d" % len(terminal_nodes)
        if len(terminal_nodes) > 0:
            paths = cgraph.find_all_paths_rev(terminal_nodes)

            # group paths by target, iterating paths in C++ std::set order
            # (path lexicographic, then target id) and replaying libstdc++
            # unordered_map iteration order for the groups — the reference's
            # output order depends on both (src/Filler.cpp:920-936)
            paths_to_compare: dict[str, list] = {}
            for path, bkpt in sorted(paths):
                key = bkpt[0] + ("_Rc" if bkpt[1] else "")
                paths_to_compare.setdefault(key, []).append(path)
            group_keys = list(paths_to_compare.keys())
            ordered_keys = [group_keys[i] for i in stdcompat.unordered_map_order(group_keys)]

            nb_total_filled = 0
            for key in ordered_keys:
                current_paths = paths_to_compare[key]
                tmp = cgraph.paths_to_sequences(current_paths, terminal_nodes)
                nb_filled = len(tmp)
                nb_total_filled += nb_filled
                if len(tmp) > 1:
                    tmp = remove_almost_identical_solutions(tmp, 90)
                nb_reported = len(tmp)

                solution_rank = 1
                for f in tmp:
                    cseq = source_seq + f.seq
                    abunds = self._coverage_scan(cseq)
                    f.median_coverage = median(abunds) if abunds else 0.0
                    f.avg_coverage = (sum(abunds) / float(len(abunds))) if abunds else 0.0
                    f.solution_count = nb_reported
                    f.solution_rank = solution_rank
                    f.compute_qual(is_anchor_repeated)
                    if reverse:
                        f.reverse()
                    solution_rank += 1
                filled.extend(tmp)

            if nb_total_filled > 0 or reverse:
                infostring[0] += "\t%d" % nb_total_filled
                infostring[0] += "\t%d" % len(filled)
        else:
            extension_out[0] = self.get_first_contig(contigs)

    def _coverage_scan(self, cseq: str):
        """Per-kmer abundances of source+insertion (src/Filler.cpp:958-987);
        works for every kmer span. Invalid (N) windows are skipped like the
        reference's canonical-iterator."""
        from ..ops.span import canonical_int

        k = self.k
        abunds = []
        codes = dna.seq_to_codes(cseq)
        fwd, valid = (None, None)
        if k <= 32:
            fwd, valid = K.kmers_from_codes(codes, k)
            canon = K.canonical_u64(fwd[valid], k)
            covs = self.graph.query_abundance_canon(canon)
            for win_i in np.nonzero(covs == 0)[0]:
                sys.stderr.write(
                    "WARNING Unknown kmer : %s\n" % K.kmer_to_str(int(fwd[valid][win_i]), k)
                )
            return [int(c) for c in covs]
        for i in range(len(cseq) - k + 1):
            win = codes[i : i + k]
            if (win == dna.INVALID).any():
                continue
            x = 0
            for c in win:
                x = (x << 2) | int(c)
            cov = self.graph.query_abundance_int(canonical_int(x, k))
            if cov == 0:
                sys.stderr.write("WARNING Unknown kmer : %s\n" % cseq[i : i + k])
            abunds.append(cov)
        return abunds

    # ------------------------------------------------------------------
    # target anchor matching (find_nodes_containing_multiple_R,
    # src/Filler.cpp:1294-1378)
    # ------------------------------------------------------------------
    def find_nodes_containing_multiple_r(self, target_dict, contigs, nb_mis_allowed):
        return find_nodes_containing_multiple_r(self.k, target_dict, contigs, nb_mis_allowed)

    def get_first_contig(self, contigs) -> str:
        """(src/Filler.cpp:1381-1407): first contig longer than k, trimmed of
        its leading k chars."""
        for c in contigs[:1]:
            if len(c) > self.k:
                return c[self.k :]
        return ""

    # ------------------------------------------------------------------
    # writers (src/Filler.cpp:1029-1291)
    # ------------------------------------------------------------------
    def write_filled_breakpoint(self, filled, seed_name, info):
        for f in filled:
            insertion = f.seq
            llen = len(insertion)
            solu_i = (
                "solution %i/%i" % (f.solution_rank, f.solution_count)
                if f.solution_count > 1
                else ""
            )
            if self.breakpoint_mode:
                self.insert_file.write(
                    ">%s_len_%d_qual_%i_avg_cov_%.2f_median_cov_%.2f   %s\n"
                    % (seed_name, llen, f.qual, f.avg_coverage, f.median_coverage, solu_i)
                )
            else:
                target_name = f.target_id[0] + ("_Rc" if f.target_id[1] else "")
                cov = int(f.median_coverage + 0.5)
                self.insert_file.write(
                    ">%s;%s;len_%s_qual_%s_median_cov_%s\t%s\n"
                    % (seed_name, target_name, llen, f.qual, cov, solu_i)
                )
            self.insert_file.write("%s\n" % insertion)

        if len(filled) > 0:
            self.nb_filled_breakpoints += 1
            if len(filled) > 1:
                self.nb_multiple_fill += 1

        self.insert_info_file.write("%s\t%s\n" % (seed_name, info))

    def write_vcf(self, filled, breakpoint_name, source_seq):
        for f in filled:
            insertion = f.seq
            left = source_seq
            filled_seq = f.seq

            # longest common suffix between source and insertion -> left
            # normalization (src/Filler.cpp:1107-1126, incl. the j wrap)
            repeat_size = 0
            i = len(left) - 1
            j = len(filled_seq) - 1
            while i > 0 and j >= 0:
                if left[i] == filled_seq[j]:
                    repeat_size += 1
                    i -= 1
                    j -= 1
                    if j == -1:
                        j = len(filled_seq) - 1
                else:
                    break

            insertion = source_seq[len(source_seq) - (repeat_size + 1) :] + insertion
            insertion = insertion[: len(insertion) - repeat_size]
            ref = source_seq[len(source_seq) - (repeat_size + 1) : len(source_seq) - repeat_size]

            tokens = breakpoint_name.split("_")
            bkpt = breakpoint_name
            position = "."
            chromosome = "."
            gt = "./."
            genotype = ""
            if len(tokens) == 7:
                bkpt = tokens[0]
                pos = _atoi(tokens[3]) - repeat_size
                position = str(pos)
                chromosome = tokens[1]
                genotype = tokens[6]
                gt = "1/1" if genotype == "HOM" else "0/1"
            if len(tokens) == 8:
                bkpt = tokens[0] + tokens[2]
                pos = _atoi(tokens[4]) - repeat_size
                position = str(pos)
                chromosome = tokens[1]
                genotype = tokens[7]
                gt = "1/1" if genotype == "HOM" else "0/1"

            qual = f.qual
            size = len(insertion) - len(ref)
            nsol = f.solution_count
            npos = repeat_size + 1
            filt = "PASS"
            if (genotype == "HET" and nsol > 1) or (genotype == "HOM" and nsol > 1):
                if self.filter:
                    break  # reference uses break: stop writing remaining solutions
                filt = "LOW_QUAL"

            self.vcf_file.write(
                "%s\t%s\t%s\t%s\t%s\t.\t%s\tTYPE=INS;LEN=%i;QUAL=%i;NSOL=%i;NPOS=%i;AVK=%.2f;MDK=%.2f\tGT\t%s\n"
                % (chromosome, position, bkpt, ref, insertion, filt, size, qual, nsol,
                   npos, f.avg_coverage, f.median_coverage, gt)
            )

    def write_to_gfa(self, filled, source_seq, seed_name, is_rc):
        seed_direction = "+"
        seed_name_node = seed_name
        if is_rc:
            seed_name = seed_name[: len(seed_name) - 3]
            seed_direction = "-"
        for f in filled:
            qual = f.qual
            insertion = f.seq
            llen = len(insertion)
            solu_i = (
                "solution %i/%i" % (f.solution_rank, f.solution_count)
                if f.solution_count > 1
                else ""
            )
            tname, t_is_rc = f.target_id
            if t_is_rc:
                target_direction = "-"
                target_name_node = tname + "_Rc"
            else:
                target_direction = "+"
                target_name_node = tname
            cov = int(f.median_coverage + 0.5)
            node_name = "%s;%s;len_%s_qual_%s_median_cov_%s %s" % (
                seed_name_node, target_name_node, llen, qual, cov, solu_i
            )
            self.gfa_file.write("S\t%s\t%s\n" % (node_name, insertion))
            self.gfa_file.write(
                "L\t%s\t%s\t%s\t+\t%iM\n" % (seed_name, seed_direction, node_name, self.contig_trim_size)
            )
            self.gfa_file.write(
                "L\t%s\t+\t%s\t%s\t%iM\n" % (node_name, tname, target_direction, self.contig_trim_size)
            )

    def write_extensions(self, contig_seq, seed_name, source_seq):
        llen = len(contig_seq)
        if llen > 0:
            self.extension_file.write(">%s_len_%d source=%s\n" % (seed_name, llen, source_seq))
            self.extension_file.write("%s\n" % contig_seq)

    # ------------------------------------------------------------------
    def _write_vcf_header(self):
        opts = self.opts
        sample = opts.get("in") or opts.get("graph") or ""
        self.vcf_file.write(
            "##fileformat=VCFv4.1\n"
            "##filedate=%s"
            "##source=MindTheGap fill version %s\n"
            "##SAMPLE=file:%s\n"
            "##REF=file:%s\n"
            '##INFO=<ID=TYPE,Number=1,Type=String,Description="INS">\n'
            '##INFO=<ID=LEN,Number=1,Type=Integer,Description="variant size">\n'
            '##INFO=<=QUAL,Number=.,Type=Integer,Description="Quality of the insertion">\n'
            '##INFO=<=AVK,Number=.,Type=Float,Description="Average k-mer coverage along the insertion">\n'
            '##INFO=<=MDK,Number=.,Type=Float,Description="Median k-mer coverage along the insertion">\n'
            '##INFO=<=NSOL,Number=1,Type=String,Description="number of alternative insertion sequences for the breakpoint">\n'
            '##INFO=<ID=NPOS,Number=1,Type=Integer,Description="number of alternative positions for the insertion site (= size of repeat (fuzzy) +1)">\n'
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tG1\n"
            % (time.ctime() + "\n", MTG_COMPAT_VERSION, sample, opts["out"])
        )

    def _resume(self, seconds) -> Properties:
        opts = self.opts
        info = Properties()
        info.add(0, "MindTheGap fill")
        info.add(1, "version", MTG_COMPAT_VERSION)
        info.add(1, "gatb-core-library", "mindthegap_tpu_torch (host engine)")
        info.add(1, "supported_kmer_sizes", KSIZE_STRING)
        info.add(0, "Parameters")
        info.add(1, "Input data")
        if opts.get("in"):
            info.add(2, "Reads", opts["in"])
        if opts.get("graph"):
            info.add(2, "Graph", opts["graph"])
        if self.breakpoint_mode:
            info.add(2, "Breakpoints", opts["bkpt"])
        else:
            info.add(2, "Contigs", opts["contig"])
        info.add(1, "Graph")
        info.add(2, "kmer-size", "%i", self.k)
        gi = self.graph.info
        if gi.get("cutoffs_auto.values"):
            info.add(2, "abundance_min (auto inferred)", gi["cutoffs_auto.values"])
        info.add(2, "abundance_min (used)", str(gi.get("thresholds", "")))
        info.add(2, "nb_solid_kmers", str(gi.get("kmers_nb_solid", "")))
        info.add(2, "nb_branching_nodes", str(gi.get("nb_branching", "")))
        info.add(1, "Assembly options")
        info.add(2, "max_depth", "%i", self.max_depth)
        info.add(2, "max_nodes", "%i", self.max_nodes)
        if not self.breakpoint_mode:
            info.add(2, "contig trim size before gap-filling", "%i", self.contig_trim_size)
        info.add(0, "Results")
        if self.breakpoint_mode:
            info.add(1, "Breakpoints")
            info.add(2, "nb_input_breakpoints", "%i", self.nb_breakpoints)
            info.add(2, "nb_filled_breakpoints", "%i", self.nb_filled_breakpoints)
        else:
            info.add(1, "Contigs")
            info.add(2, "nb_input_contigs", "%i", self.nb_contigs)
            info.add(2, "nb_used_contigs", "%i", self.nb_used_contigs)
            info.add(2, "nb_input_seeds", "%i", self.nb_breakpoints)
            info.add(2, "nb_filled_seeds", "%i", self.nb_filled_breakpoints)
        info.add(3, "as_unique_sequence", "%i", self.nb_filled_breakpoints - self.nb_multiple_fill)
        info.add(3, "as_multiple_sequence", "%i", self.nb_multiple_fill)
        info.add(1, "Time", "%.1f s", seconds)
        if self.opts.get("profile"):
            self.phases.add_to_info(info, 1)
        info.add(1, "Output files")
        info.add(2, "assembled sequence file", self.insert_file_name)
        if self.breakpoint_mode:
            info.add(2, "insertion variant vcf file", self.vcf_file_name)
        else:
            info.add(2, "assembly graph file", self.gfa_file_name)
        info.add(2, "assembly statistics file", self.insert_info_file_name)
        if self.extend:
            info.add(2, "extension sequence file", self.extension_file_name)
        return info


def run_fill(opts: dict, out=None) -> Properties:
    return Filler(opts, out).execute()
