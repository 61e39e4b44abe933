"""Command-line front end: `MindTheGap <find|fill> [-opt value ...]`.

Keeps the reference CLI surface verbatim — module names, single-dash option
names, defaults, hidden options, and the help/version screens
(src/main.cpp:62-123, src/Finder.cpp:97-171, src/Filler.cpp:76-113).
Run as `python -m mindthegap_tpu_torch <find|fill> ...`.
"""

from __future__ import annotations

import sys

from . import MTG_COMPAT_VERSION, KSIZE_STRING


class OptionFailure(Exception):
    pass


# name -> (takes_value, default, help, visible)
FIND_OPTIONS = {
    "in": (True, None, "input read file(s)", True),
    "graph": (True, None, "input graph file (likely a hdf5 file)", True),
    "ref": (True, None, "reference genome file", True),
    "bed": (True, None, "bed file to restrict breakpoint search in specific regions", True),
    "out-tmp": (True, ".", "prefix for output temporary files", True),
    "out": (True, None, "prefix for output files", True),
    "kmer-size": (True, "31", "size of a kmer", True),
    "abundance-min": (True, "auto", "minimal abundance threshold for solid kmers", True),
    "abundance-max": (True, "2147483647", "maximal abundance threshold for solid kmers", True),
    "homo-only": (False, None, "search only homozygous breakpoints", True),
    "max-rep": (True, "5", "maximal repeat size detected for fuzzy sites", True),
    "branching-filter": (True, "15", "branching filter paramater for heterozygous insertions, maximal number of branching kmers in a 100-bp window before a heterozygous site (if -1 = no filter)", True),
    "het-max-occ": (True, "1", "maximal number of occurrences of a kmer in the reference genome allowed for heterozyguous breakpoints", True),
    "insert-only": (False, None, "search only insertion breakpoints (do not report other variants)", True),
    "snp-min-val": (True, "5", "minimal number of kmers to validate a SNP", False),
    "snp-only": (False, None, "search only SNPs", False),
    "deletion-only": (False, None, "search only deletion variants", False),
    "hete-only": (False, None, "search only heterozygous insertion breakpoints", False),
    "no-snp": (False, None, "do not search SNPs", False),
    "no-insert": (False, None, "do not search insertion breakpoints", False),
    "no-deletion": (False, None, "do not search deletions", False),
    "no-hetero": (False, None, "do not search heterozygous insertion breakpoints", False),
    "backup": (False, None, "report also unusual breakpoints (gap size is larger than kmer-size/2 and does not validate a common variant)", False),
    "nb-cores": (True, "0", "number of cores", True),
    "max-disk": (True, "0", "max disk for graph building (in MBytes)", True),
    "max-memory": (True, "2000", "max memory for graph building (in MBytes)", True),
    "verbose": (True, "1", "verbosity level", True),
    "scan-engine": (True, "auto", "reference-scan engine: auto | host | device | device-qp | device-qb | sharded | sharded-mem", False),
    "scan-memory": (True, "0", "per-chip memory budget for the replicated scan map in MBytes (0 = auto); exceeded -> sharded-mem membership routing on a mesh", False),
    "count-engine": (True, "auto", "k-mer counting engine: auto | host | device | sharded | partitioned", False),
    "automaton": (True, "auto", "breakpoint automaton: auto | native | host", False),
    "profile": (False, None, "add per-phase wall-clock timings to the result report", False),
    "profile-trace": (True, None, "directory for a profiler trace of the run (not yet ported)", False),
    "device": (True, "cuda", "device of the reference scan and of -count-engine device: cuda | cpu (cpu runs the kernels' plain versions, for tests)", False),
}

FILL_OPTIONS = {
    "in": (True, None, "input read file(s)", True),
    "graph": (True, None, "input graph file (likely a hdf5 file)", True),
    "contig": (True, None, "contig file", True),
    "bkpt": (True, None, "breakpoint file", True),
    "out": (True, None, "prefix for output files", True),
    "overlap": (True, "0", "Overlap between input contigs (default, ie. 0 = kmer size)", True),
    "filter": (False, None, "do not output low quality insertions (bkpt mode)", True),
    "extend": (False, None, "output first-contig extensions of failed gap-fillings in a separate file", True),
    "kmer-size": (True, "31", "size of a kmer", True),
    "abundance-min": (True, "auto", "minimal abundance threshold for solid kmers", True),
    "abundance-max": (True, "2147483647", "maximal abundance threshold for solid kmers", True),
    "max-nodes": (True, "100", "maximum number of nodes in contig graph (nt)", True),
    "max-length": (True, "10000", "maximum length of insertions (nt)", True),
    "fwd-only": (False, None, "do not try in reverse direction if no inserted sequence is assembled (bkpt mode)", True),
    "fill-engine": (True, "auto", "gap-fill walk engine: auto (native C++ when available) | native | host | device | device-qb", False),
    "count-engine": (True, "auto", "k-mer counting engine: auto | host | device | sharded | partitioned", False),
    "nb-cores": (True, "0", "number of cores", True),
    "max-disk": (True, "0", "max disk for graph building   (in MBytes)", True),
    "max-memory": (True, "2000", "max memory for graph building (in MBytes)", True),
    "verbose": (True, "1", "verbosity level", True),
    "profile": (False, None, "add per-phase wall-clock timings to the result report", False),
    "profile-trace": (True, None, "directory for a profiler trace of the run (not yet ported)", False),
    "device": (True, "cuda", "device of the device engines (-fill-engine device|device-qb, -count-engine device): cuda | cpu (cpu runs the kernels' plain versions, for tests)", False),
}


def parse_options(argv: list[str], spec: dict) -> dict:
    opts: dict = {}
    for name, (takes_value, default, _h, _v) in spec.items():
        if takes_value and default is not None:
            opts[name] = default
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-help", "-h"):
            raise OptionFailure("")
        if not a.startswith("-"):
            raise OptionFailure(f"Unknown parameter '{a}'")
        name = a[1:]
        if name not in spec:
            raise OptionFailure(f"Unknown parameter '{a}'")
        takes_value = spec[name][0]
        if takes_value:
            if i + 1 >= len(argv):
                raise OptionFailure(f"Option '{a}' expects a value")
            opts[name] = argv[i + 1]
            i += 2
        else:
            opts[name] = True
            i += 1
    return opts


def display_version(out):
    out.write("* * * * * * * * * * * * * * * * * * * * * *\n")
    out.write(f"* MindTheGap version {MTG_COMPAT_VERSION} (torch port)   *\n")
    out.write("* Engine: mindthegap_tpu_torch (CUDA)     *\n")
    out.write(f"* Supported kmer sizes <{KSIZE_STRING}   *\n")
    out.write("* * * * * * * * * * * * * * * * * * * * * *\n")


def display_help(out):
    out.write(f"\nMindTheGap version {MTG_COMPAT_VERSION}\n\n")
    out.write("Usage: MindTheGap <module> [module options]\n\n")
    out.write("[MindTheGap modules]\n")
    out.write("    find     :    insertion breakpoint detection\n")
    out.write("                  usage: MindTheGap find (-in <reads.fq> | -graph <graph.h5>) -ref <reference.fa> [options]\n")
    out.write("                  help: MindTheGap find -help\n")
    out.write("    fill     :    gap-filler or insertion assembly\n")
    out.write("                  usage: MindTheGap fill (-in <reads.fq> | -graph <graph.h5>) (-bkpt <breakpoints.fa> | -contig <contig.fa>) [options]\n")
    out.write("                  help: MindTheGap fill -help\n")
    out.write("[Common options]\n")
    out.write("    -help    :    display this help menu\n")
    out.write("    -version :    display current version\n\n")


def module_help(out, module: str, spec: dict):
    if module == "find":
        out.write("\nUsage:  MindTheGap find (-in <reads.fq> | -graph <graph.h5>) -ref <reference.fa> [options]\n")
    else:
        out.write("\nUsage:  MindTheGap fill (-in <reads.fq> | -graph <graph.h5>) -bkpt <breakpoints.fa or -contig <contig.fa> [options]\n")
    for name, (takes_value, default, help_str, visible) in spec.items():
        if not visible:
            continue
        kind = "(1 arg)" if takes_value else "(0 arg)"
        dflt = f" [default '{default}']" if default is not None else ""
        out.write(f"    -{name:<20s} {kind} : {help_str}{dflt}\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = sys.stdout
    if not argv:
        display_help(out)
        return 1
    cmd = argv[0]
    if cmd in ("-version", "-v"):
        display_version(out)
        return 0
    if cmd in ("-help", "-h"):
        display_help(out)
        return 0
    if cmd not in ("find", "fill"):
        sys.stderr.write("options find and fill are incompatible, but at least one of these is mandatory\n")
        return 1

    spec = FIND_OPTIONS if cmd == "find" else FILL_OPTIONS
    try:
        opts = parse_options(argv[1:], spec)
    except OptionFailure as e:
        if str(e):
            out.write(f"\nEXCEPTION: {e}\n")
        module_help(out, cmd, spec)
        return 1

    try:
        if cmd == "find":
            from .find.runner import run_find

            run_find(opts, out)
        else:
            from .fill.runner import run_fill

            run_fill(opts, out)
    except Exception as e:  # mirror main.cpp's EXCEPTION channel
        msg = str(e)
        if msg:
            out.write(f"\nEXCEPTION: {msg}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
