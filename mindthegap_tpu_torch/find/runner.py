"""`find` module orchestration (the reference Finder tool, src/Finder.cpp).

Builds or loads the de Bruijn graph (counted on the host, or on the device
with -count-engine device: kernels K3 and K4), builds the
reference-repeat set and the pair-coalesced scan map on the host, then
scans every reference sequence on the device (find/scan_device.py, kernel
K1 on CUDA) and replays the class stream in the native automaton
(native/automaton.cpp), which writes `<out>.breakpoints` +
`<out>.othervariants.vcf`. Mode flags follow src/Finder.cpp:320-398.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import MTG_COMPAT_VERSION, KSIZE_STRING, NotYetPorted
from ..device import resolve_device
from ..graph import dbg
from ..io.bank import Bank
from ..utils import dna
from ..utils.progress import Progress
from ..utils.properties import Properties


class FinderError(Exception):
    pass


class _StatsHolder:
    def __init__(self, stats):
        self.stats = stats


def default_output_prefix() -> str:
    return "MindTheGap_Expe-" + time.strftime("%Y-%m-%d.%I:%M")


def _stoi(s: str) -> int:
    """std::stoi semantics: parse the leading integer, ignore the rest."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        raise ValueError(f"stoi: no conversion: {s!r}")
    return int(s[:j])


def parse_bed_for_chrom(bed_path: str, chrom_name: str, k: int):
    """Collect this chromosome's intervals, in file order, keeping those
    longer than k (src/FindBreakpoints.hpp:461-490)."""
    intervals = []
    with open(bed_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) == 0 or line[0] in "#@":
                continue
            v = line.split("\t")
            if v[0] == chrom_name:
                bed_begin, bed_end = _stoi(v[1]), _stoi(v[2])
                if bed_end - bed_begin > k:
                    intervals.append((bed_begin, bed_end))
    return intervals


@dataclass
class FindStats:
    homo_clean: int = 0
    homo_fuzzy: int = 0
    hetero_clean: int = 0
    hetero_fuzzy: int = 0
    fuzzy_deletion: int = 0
    clean_deletion: int = 0
    solo_snp: int = 0
    multi_snp: int = 0
    backup: int = 0
    homo_clean_indel: int = 0
    homo_fuzzy_indel: int = 0
    hetero_indel: int = 0


_VALID_SCAN_ENGINES = ("auto", "host", "device", "device-qp", "device-qb", "sharded", "sharded-mem")
_PORTED_SCAN_ENGINES = ("auto", "device-qp")


def _validate_scan_engine(engine: str):
    if engine not in _VALID_SCAN_ENGINES:
        raise FinderError(
            "ERROR: unknown -scan-engine %r (choose from %s)"
            % (engine, ", ".join(_VALID_SCAN_ENGINES))
        )
    if engine not in _PORTED_SCAN_ENGINES:
        raise NotYetPorted(f"-scan-engine {engine}")


def _check_table_fits(nbytes: int, device: torch.device, scan_memory_mb: int):
    """The scan map is replicated on the device: refuse a table above the
    -scan-memory budget, or above the card's memory when none is given."""
    if scan_memory_mb > 0:
        budget = scan_memory_mb << 20
    elif device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory
    else:
        return
    if nbytes > budget:
        raise FinderError(
            f"ERROR: the scan map needs {nbytes >> 20} MB, above the {budget >> 20} MB budget "
            "of one device (membership sharding across devices is not yet ported)"
        )


def _make_pay_feed_fn(graph, repeat_set, k: int, device: torch.device, scan_memory_mb: int = 0,
                      window: int = 1 << 22, exc_cap: int | None = None):
    """Class-stream scan feed for the native automaton: returns a factory
    `codes -> iterator of chunks` for NativeScanner.scan_sequence_pay.

    Windows of `window` bases (halo k-1; the last one cut to the sequence)
    go up 2-bit packed; the device returns the 2-bit class stream plus the
    exception payloads (scan_cls_qp). A window with more exceptions than
    its cap (default 12.5% of its payload entries) is re-dispatched dense
    (scan_pay_qp). Window g is dispatched before window g-1 is replayed:
    CUDA launches and the device->host copies are asynchronous, so the
    device computes g while the host replays g-1."""
    from ..ops import extmap as X
    from .scan_device import pack_codes_host, scan_cls_qp, scan_pay_qp, unpack_codes

    qp = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers)
    _check_table_fits(qp.nbytes, device, scan_memory_mb)
    tables = qp.to(device)
    targs = (tables.slots, tables.stash_keys, tables.stash_l, tables.stash_r)
    log_size = qp.log_size
    del qp, tables  # only the device copy is used from here
    halo = k - 1
    step = window - halo
    on_cuda = device.type == "cuda"

    def dispatch(part):
        # a multiple of 8 bases (the bad-bit packing), at least k + 8
        wlen = max(-(-part.shape[0] // 8) * 8, -(-(k + 8) // 8) * 8)
        row = np.full(wlen, 255, np.uint8)
        row[: part.shape[0]] = part
        cap = exc_cap if exc_cap is not None else (wlen - k + 2 + 3) // 4 * 4 // 8
        packed, bad = pack_codes_host(row)
        packed = torch.from_numpy(packed).to(device)
        bad = torch.from_numpy(bad).to(device)
        res = scan_cls_qp(packed, bad, *targs, log_size, k, cap)
        # the copies are queued behind the kernel; the host waits on the
        # event only when it replays this window
        host = {key: v.to("cpu", non_blocking=on_cuda) for key, v in res.items()}
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record()
        return host, done, packed, bad, cap

    def feed(codes):
        npos = codes.shape[0] - k + 1
        if npos <= 0:
            return
        nwin = -(-npos // step)
        takes = [min(step, npos - i * step) for i in range(nwin)]

        def emit(w, pending):
            host, done, packed, bad, cap = pending
            if done is not None:
                done.synchronize()
            # the global payload stream has npos+1 entries; the final window
            # contributes its take + 1
            n_feed = takes[w] + (1 if w == nwin - 1 else 0)
            n_exc = int(host["n_exc"])
            if n_exc > cap:
                # exception-heavy window: re-dispatch dense
                r = scan_pay_qp(unpack_codes(packed, bad), *targs, log_size, k)
                yield ("pay", r["pay8"].cpu().numpy()[:n_feed], r["rep8"].cpu().numpy(), None, n_feed)
            else:
                exc16 = host["exc16"].numpy().view(np.uint16)
                yield ("cls", host["cls2"].numpy(), exc16, n_exc, n_feed)

        pending = None
        for w in range(nwin):
            res = dispatch(codes[w * step : w * step + window])
            if pending is not None:
                yield from emit(w - 1, pending)
            pending = res
        yield from emit(nwin - 1, pending)

    return feed


def run_find(opts: dict, out=None) -> Properties:
    """Execute the find module. opts uses the reference option names
    (without leading dash)."""
    import sys

    out = out or sys.stdout

    has_graph = bool(opts.get("graph"))
    has_in = bool(opts.get("in"))
    if has_graph == has_in:
        raise FinderError(
            "ERROR: options -graph and -in are incompatible, but at least one of these is mandatory"
        )
    if not opts.get("ref"):
        raise FinderError("ERROR: option -ref is mandatory")

    if not opts.get("out"):
        opts["out"] = default_output_prefix()
    prefix = opts["out"]

    device = resolve_device(opts.get("device"))
    scan_engine = opts.get("scan-engine", "auto")
    _validate_scan_engine(scan_engine)
    if opts.get("automaton", "auto") not in ("auto", "native"):
        raise NotYetPorted(f"-automaton {opts['automaton']}")
    if has_in and int(opts.get("kmer-size", 31)) > 32:  # checked before the graph build
        raise NotYetPorted("find with -kmer-size above 32")

    from ..utils.phases import PhaseTimer, maybe_trace

    phases = PhaseTimer()
    trace_ctx = maybe_trace(opts.get("profile-trace"))
    trace_ctx.__enter__()

    t0 = time.time()
    if has_in:
        with phases.phase("graph build"):
            graph = dbg.build_graph(
                opts["in"],
                int(opts.get("kmer-size", 31)),
                opts.get("abundance-min", "auto"),
                int(opts.get("abundance-max", 2147483647)),
                count_engine=str(opts.get("count-engine", "auto")),
                max_memory_mb=int(opts.get("max-memory", 2000)),
                max_disk_mb=int(opts.get("max-disk", 0)),
                tmp_prefix=str(opts.get("out-tmp", ".")) or None,
                device=device,
            )
            k = int(opts.get("kmer-size", 31))
            graph.save(prefix + ".h5")
    else:
        with phases.phase("graph load"):
            graph = dbg.Graph.load(opts["graph"])
            k = graph.k
    if k > 32:  # a loaded graph
        raise NotYetPorted("find with -kmer-size above 32")

    bed_file = opts.get("bed", "")

    # mode flags (src/Finder.cpp:320-398)
    homo_only = False
    homo_insert = True
    hete_insert = True
    snp = True
    backup = False
    deletion = True
    small_homo = True

    if opts.get("homo-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = True, True, False, True, False, True
    if opts.get("insert-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = False, True, True, False, False, False
    if opts.get("snp-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = True, False, False, True, False, False
    if opts.get("deletion-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = True, False, False, False, False, True
    if opts.get("hete-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = False, False, True, False, False, False
    if opts.get("backup"):
        backup = True
    if opts.get("no-snp"):
        snp = False
    if opts.get("no-insert"):
        homo_insert = False
    if opts.get("no-deletion"):
        deletion = False
    if opts.get("no-hetero"):
        hete_insert = False

    max_repeat = int(opts.get("max-rep", 5))
    het_max_occ = max(1, int(opts.get("het-max-occ", 1)))
    snp_min_val = int(opts.get("snp-min-val", 5))
    branching_threshold = int(opts.get("branching-filter", 15))

    breakpoint_name = prefix + ".breakpoints"
    vcf_name = prefix + ".othervariants.vcf"

    ref_uri = opts["ref"]
    with phases.phase("reference repeat set"):
        repeat_set = dbg.build_repeat_set(ref_uri, k - 1, het_max_occ + 1)

    from . import native_scan

    with open(breakpoint_name, "w") as bkpt_f, open(vcf_name, "w") as vcf_f:
        _write_vcf_header(vcf_f, opts)

        ctx = native_scan.NativeScanner(
            graph, repeat_set, k,
            max_repeat=max_repeat, snp_min_val=snp_min_val,
            branching_threshold=branching_threshold, homo_only=homo_only,
            snp=snp, deletion=deletion, small_homo=small_homo,
            homo_insert=homo_insert, backup=backup, hete_insert=hete_insert,
        )

        refbank = Bank.open(ref_uri)
        verbose = int(opts.get("verbose", 1))
        progress = Progress(
            refbank.estimate_sequences_size(), "Finding breakpoints", enabled=verbose > 0
        )
        with phases.phase("scan engine setup"):
            scan_mem = int(opts.get("scan-memory", 0))
            pay_feed = _make_pay_feed_fn(graph, repeat_set, k, device, scan_memory_mb=scan_mem)
        for rec in refbank:
            codes = dna.seq_to_codes(rec.seq)
            bed_intervals = None
            if bed_file:
                bed_intervals = parse_bed_for_chrom(bed_file, rec.comment_short, k)
            with phases.phase("scan+replay (fused)"):
                ctx.scan_sequence_pay(rec.comment_short, rec.seq, pay_feed(codes), bed_intervals)
            progress.inc(len(rec.seq))
        progress.finish()

        bkpt_text, vcf_text, native_stats = ctx.results()
        bkpt_f.write(bkpt_text)
        vcf_f.write(vcf_text)
        ctx.close()
        ctx = _StatsHolder(FindStats(**native_stats))

    seconds = time.time() - t0
    trace_ctx.__exit__(None, None, None)
    info = _resume(opts, graph, ctx, k, device, seconds, breakpoint_name, vcf_name,
                   max_repeat, het_max_occ, branching_threshold,
                   homo_insert, hete_insert, snp, deletion, bed_file,
                   phases if opts.get("profile") else None)
    out.write(info.dump())
    return info


def _write_vcf_header(vcf_f, opts):
    sample = opts.get("in") or opts.get("graph") or ""
    vcf_f.write(
        "##fileformat=VCFv4.1\n"
        "##filedate=%s"
        "##source=MindTheGap find version %s\n"
        "##SAMPLE=file:%s\n"
        "##REF=file:%s\n"
        '##INFO=<ID=TYPE,Number=1,Type=String,Description="SNP, INS, DEL or .">\n'
        '##INFO=<ID=LEN,Number=1,Type=Integer,Description="variant size">\n'
        '##INFO=<ID=FUZZY,Number=1,Type=Integer,Description="repeat size at the breakpoint, only for INS and DEL">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tG1\n"
        % (time.ctime() + "\n", MTG_COMPAT_VERSION, sample, opts["ref"])
    )


def _resume(opts, graph, ctx, k, device, seconds, bkpt_name, vcf_name,
            max_repeat, het_max_occ, branching_threshold,
            homo_insert, hete_insert, snp, deletion, bed_file,
            phases=None) -> Properties:
    s = ctx.stats
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    info = Properties()
    info.add(0, "MindTheGap find")
    info.add(1, "version", MTG_COMPAT_VERSION)
    info.add(1, "gatb-core-library", "mindthegap_tpu_torch (%s)" % device_name)
    info.add(1, "supported_kmer_sizes", KSIZE_STRING)
    info.add(0, "Parameters")
    info.add(1, "Input data")
    if opts.get("in"):
        info.add(2, "Reads", opts["in"])
    if opts.get("graph"):
        info.add(2, "Graph", opts["graph"])
    info.add(2, "Reference", opts["ref"])
    if bed_file:
        info.add(2, "Bed file", bed_file)
    info.add(1, "Graph")
    info.add(2, "kmer-size", "%i", k)
    gi = graph.info
    if gi.get("cutoffs_auto.values"):
        info.add(2, "abundance_min (auto inferred)", gi["cutoffs_auto.values"])
    info.add(2, "abundance_min (used)", str(gi.get("thresholds", "")))
    if "abundance_max" in gi:
        info.add(2, "abundance_max", str(gi["abundance_max"]))
    info.add(2, "nb_solid_kmers", str(gi.get("kmers_nb_solid", "")))
    info.add(2, "nb_branching_nodes", str(gi.get("nb_branching", "")))
    info.add(1, "Breakpoint detection options")
    info.add(2, "max_repeat", "%i", max_repeat)
    info.add(2, "hetero_max_occ", "%i", het_max_occ)
    info.add(2, "branching filter value", "%i", branching_threshold)
    info.add(2, "homo_insertions", "yes" if homo_insert else "no")
    info.add(2, "hete_insertions", "yes" if hete_insert else "no")
    info.add(2, "snp", "yes" if snp else "no")
    info.add(2, "deletion", "yes" if deletion else "no")
    info.add(0, "Results")
    info.add(1, "Insertion breakpoints")
    info.add(2, "homozygous", "%i", s.homo_clean + s.homo_fuzzy)
    info.add(3, "clean", "%i", s.homo_clean)
    info.add(3, "fuzzy", "%i", s.homo_fuzzy)
    info.add(2, "heterozygous", "%i", s.hetero_clean + s.hetero_fuzzy)
    info.add(3, "clean", "%i", s.hetero_clean)
    info.add(3, "fuzzy", "%i", s.hetero_fuzzy)
    info.add(1, "Other variants")
    info.add(2, "deletions", "%i", s.clean_deletion + s.fuzzy_deletion)
    info.add(2, "Homozygous insertions 1-2 bp size", "%i", s.homo_clean_indel + s.homo_fuzzy_indel)
    info.add(2, "Heterozygous insertions 1-2 bp size", "%i", s.hetero_indel)
    info.add(2, "SNPs", "%i", s.solo_snp + s.multi_snp)
    info.add(1, "Time", "%.1f s", seconds)
    if phases is not None:
        info.add(1, "Per-phase timings")
        phases.add_to_info(info, 2)
    info.add(1, "Output files")
    if opts.get("in"):
        info.add(2, "graph_file", "%s.h5", opts["out"])
    info.add(2, "breakpoint_file", bkpt_name)
    info.add(2, "othervariants_file", vcf_name)
    return info
