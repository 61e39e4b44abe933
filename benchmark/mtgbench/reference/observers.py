"""The detector (observer) cascade of `find`.

Each class replays one reference observer exactly — same trigger windows,
same off-by-ones, same write formats, same scanner-state mutations:

- FindSoloSNP / FindMultiSNP / FindMultiSNPrev   (src/FindSNP.hpp)
- FindDeletion                                    (src/FindDeletion.hpp)
- FindSmallCleanInsertion / FindSmallFuzzyInsertion (src/FindSmallInsertion.hpp)
- FindCleanInsertion / FindFuzzyInsertion         (src/FindInsertion.hpp)
- FindBackup                                      (src/FindBackup.hpp)
- FindHeteroInsertion                             (src/FindHeteroInsertion.hpp)

Registration order defines detection priority (src/Finder.cpp:543-586).
All index arithmetic on the 256-slot history is unsigned-char modular.
A frozen copy of the port's find/observers.py (the benchmark's reference).
"""

from __future__ import annotations

from .automaton import (
    Kmer,
    ScanContext,
    STR_BKP_TYPE,
    STR_DEL_TYPE,
    STR_HET_TYPE,
    STR_HOM_TYPE,
    STR_SNP_TYPE,
    U64,
)
from . import kmers as K

# 1-2 bp candidate insertions tried by the micro-assembly detectors
# (src/FindSmallInsertion.hpp:72)
NUCLEO_1_2 = [
    "A", "C", "G", "T",
    "AA", "AC", "AG", "AT", "CA", "CC", "CG", "CT",
    "GA", "GC", "GG", "GT", "TA", "TC", "TG", "TT",
]


class Observer:
    def __init__(self, find: ScanContext):
        self.f = find

    def update(self) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError


# ---------------------------------------------------------------------------
# SNP machinery (FindSNP base, src/FindSNP.hpp:78-293)
# ---------------------------------------------------------------------------
class _SNPBase(Observer):
    def mutate_kmer(self, kmer: int, nuc: int, pos: int) -> int:
        return K.mutate_kmer(kmer, nuc, pos, self.f.k)

    @staticmethod
    def nuc_to_char(nuc: int) -> str:
        return "ACTG"[nuc]

    def snp_at_end(self, beginpos: list, limit: int):
        """Mutates the last nt of the kmer at history[beginpos], walking
        forward. Returns (found, nuc, ref_nuc, nb_kmer_val); advances
        beginpos to the first non-solid kmer on success, restores on failure
        (src/FindSNP.hpp:139-208)."""
        f = self.f
        nuc = {0: 0, 1: 0, 2: 0, 3: 0}
        beginpos_init = beginpos[0]
        ref_nuc = f.history[beginpos[0]].kmer & 3
        nuc.pop(ref_nuc, None)

        end = False
        j = 0
        while not end and j != f.k:
            for n in sorted(nuc.keys()):  # std::map iterates keys in order
                correct = self.mutate_kmer(f.history[beginpos[0]].kmer, n, f.k - j)
                if f.contains(correct):
                    nuc[n] += 1
                else:
                    if len(nuc) == 1:
                        end = True
                        beginpos[0] = (beginpos[0] - 1) % 256
                        break
                    del nuc[n]
            beginpos[0] = (beginpos[0] + 1) % 256
            j += 1

        best = min(nuc.keys())
        for n in sorted(nuc.keys()):
            if nuc[n] > nuc[best]:
                best = n
        if nuc[best] >= limit:
            return True, best, ref_nuc, nuc[best]
        beginpos[0] = beginpos_init
        return False, best, ref_nuc, 0

    def snp_at_begin(self, beginpos: list, limit: int):
        """Mutates the first nt of the kmer at history[beginpos], walking
        backward (src/FindSNP.hpp:219-293)."""
        f = self.f
        nuc = {0: 0, 1: 0, 2: 0, 3: 0}
        beginpos_init = beginpos[0]
        ref_nuc = (f.history[beginpos[0]].kmer >> (2 * (f.k - 1))) & 3
        nuc.pop(ref_nuc, None)

        end = False
        j = 0
        while not end and j != f.k:
            for n in sorted(nuc.keys()):
                correct = self.mutate_kmer(f.history[beginpos[0]].kmer, n, j + 1)
                if f.contains(correct):
                    nuc[n] += 1
                else:
                    if len(nuc) == 1:
                        end = True
                        beginpos[0] = (beginpos[0] + 1) % 256
                        break
                    del nuc[n]
            beginpos[0] = (beginpos[0] - 1) % 256
            j += 1

        best = min(nuc.keys())
        for n in sorted(nuc.keys()):
            if nuc[n] > nuc[best]:
                best = n
        if nuc[best] >= limit:
            return True, best, ref_nuc, nuc[best]
        beginpos[0] = beginpos_init
        return False, best, ref_nuc, 0

    def correct_history(self, pos: int, nuc: int):
        """Rewrite k history slots with the SNP-corrected kmers
        (src/FindSNP.hpp:357-381 / 547-564)."""
        f = self.f
        for i in range(f.k):
            index = (i + pos) % 256
            mutated = self.mutate_kmer(f.history[index].kmer, nuc, f.k - i)
            f.history[index].kmer = mutated
            if f.contains(mutated):
                f.history[index].nb_in = f.nb_in_branch(mutated)
                f.history[index].nb_out = f.nb_out_branch(mutated)
                f.history[index].is_repeated = f.suffix_is_repeated(mutated)


class FindSoloSNP(_SNPBase):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.gap_stretch_size == f.k:
            pos = [(f.het_kmer_begin_index - 1) % 256]
            save_index = pos[0]
            found, nuc, ref_nuc, _ = self.snp_at_end(pos, f.k)
            if found:
                self.correct_history(save_index, nuc)
                f.write_vcf_variant(
                    f.breakpoint_id, f.chrom_name, f.position - 2,
                    self.nuc_to_char(ref_nuc), self.nuc_to_char(nuc), 0, STR_SNP_TYPE,
                )
                f.breakpoint_id_iterate()
                f.stats.solo_snp += 1
                return True
        return False


class FindMultiSNP(_SNPBase):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        kmer_threshold = f.snp_min_val
        if f.gap_stretch_size > f.k + kmer_threshold:
            begin_pos = (f.position - 1 - f.gap_stretch_size + f.k - 1) & U64
            begin_pos_init = begin_pos

            index_end = (f.het_kmer_begin_index + f.k - 1) % 256  # first solid kmer
            index_pos = [(index_end - f.gap_stretch_size) % 256]  # first non-solid

            while index_pos[0] != index_end:
                save_index = index_pos[0]
                found, nuc, ref_nuc, nb_kmer_val = self.snp_at_end(index_pos, kmer_threshold)
                if found:
                    if ((begin_pos + nb_kmer_val - begin_pos_init) & U64) > f.gap_stretch_size:
                        break  # would go beyond the gap
                    self.correct_history(save_index, nuc)
                    f.write_vcf_variant(
                        f.breakpoint_id, f.chrom_name, begin_pos,
                        self.nuc_to_char(ref_nuc), self.nuc_to_char(nuc), 0, STR_SNP_TYPE,
                    )
                    f.breakpoint_id_iterate()
                    f.stats.multi_snp += 1
                    begin_pos = (begin_pos + nb_kmer_val) & U64
                else:
                    break

            nb_kmer_correct = (begin_pos - begin_pos_init) & U64
            if nb_kmer_correct == 0:
                return False
            if nb_kmer_correct != f.gap_stretch_size:
                f.gap_stretch_size -= nb_kmer_correct
                f.solid_stretch_size += nb_kmer_correct
                f.kmer_begin = Kmer(f.history[(index_pos[0] - 1) % 256].kmer, True)
                return False
            return True
        return False


class FindMultiSNPrev(_SNPBase):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        kmer_threshold = f.snp_min_val
        if f.gap_stretch_size > f.k + kmer_threshold:
            begin_pos = (f.position - 2) & U64
            begin_pos_init = begin_pos

            index_limit = (f.het_kmer_end_index - 2 - f.gap_stretch_size) % 256  # last solid
            index_pos = [(f.het_kmer_end_index - 2) % 256]  # last non-solid

            while index_pos[0] != index_limit:
                save_index = index_pos[0]
                found, nuc, ref_nuc, nb_kmer_val = self.snp_at_begin(index_pos, kmer_threshold)
                if found:
                    if ((begin_pos_init - ((begin_pos - nb_kmer_val) & U64)) & U64) > f.gap_stretch_size:
                        break
                    self.correct_history((save_index - (f.k - 1)) % 256, nuc)
                    f.write_vcf_variant(
                        f.breakpoint_id, f.chrom_name, begin_pos,
                        self.nuc_to_char(ref_nuc), self.nuc_to_char(nuc), 0, STR_SNP_TYPE,
                    )
                    f.breakpoint_id_iterate()
                    f.stats.multi_snp += 1
                    begin_pos = (begin_pos - nb_kmer_val) & U64
                else:
                    break

            nb_kmer_correct = (begin_pos_init - begin_pos) & U64
            if nb_kmer_correct == 0:
                return False
            if nb_kmer_correct != f.gap_stretch_size:
                f.position = (f.position - nb_kmer_correct) & U64
                f.het_kmer_end_index = (f.het_kmer_end_index - nb_kmer_correct) % 256
                f.het_kmer_begin_index = (f.het_kmer_begin_index - nb_kmer_correct) % 256
                f.gap_stretch_size -= nb_kmer_correct
                f.kmer_end = Kmer(f.history[(index_pos[0] + 1) % 256].kmer, True)
                return False
            return True
        return False


# ---------------------------------------------------------------------------
# Deletions (src/FindDeletion.hpp)
# ---------------------------------------------------------------------------
class FindDeletion(Observer):
    def fuzzy_site(self, begin: str, end: str) -> int:
        # (src/FindDeletion.hpp:179-188) — note substr clamps at string end
        for i in range(self.f.max_repeat, 0, -1):
            j = 1
            while begin[len(begin) - i : len(begin) - i + j] == end[0:j]:
                if i == j:
                    return j
                j += 1
        return 0

    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.gap_stretch_size < f.k - f.max_repeat:
            return False

        begin = f.to_string(f.kmer_begin.fwd)
        end = f.to_string(f.kmer_end.fwd)

        repeat_size = self.fuzzy_site(begin, end)
        if repeat_size > f.max_repeat:
            return False
        if repeat_size != 0:
            begin = begin[: len(begin) - repeat_size]

        del_size = int(f.gap_stretch_size) - f.k + repeat_size + 1

        seq = begin + end
        is_deletion = f.seq_kmers_all_contained(seq)

        if not is_deletion:
            if repeat_size == 0:
                return False
            # maybe not a fuzzy deletion: retry with the untruncated begin
            seq = f.to_string(f.kmer_begin.fwd) + end
            if not f.seq_kmers_all_contained(seq):
                return False
            del_size -= repeat_size
            repeat_size = 0

        if del_size <= 0:
            return False

        del_start_pos = (f.position - 2 - del_size) & U64
        del_sequence = f.chrom_seq[del_start_pos : del_start_pos + del_size + 1]
        alt_char = del_sequence[0:1]
        f.write_vcf_variant(
            f.breakpoint_id, f.chrom_name, del_start_pos, del_sequence, alt_char,
            repeat_size, STR_DEL_TYPE,
        )
        f.breakpoint_id_iterate()
        if repeat_size != 0:
            f.stats.fuzzy_deletion += 1
        else:
            f.stats.clean_deletion += 1
        return True


# ---------------------------------------------------------------------------
# 1-2 bp micro insertions (src/FindSmallInsertion.hpp)
# ---------------------------------------------------------------------------
def _micro_assembly(f: ScanContext, kmer_begin_str: str, kmer_end_str: str, ref: str):
    """Try the 20 one/two-base insertions; accept iff the first k kmers of
    begin+ins+end are all in the graph. Returns alt string or None."""
    for ins in NUCLEO_1_2:
        seq = kmer_begin_str + ins + kmer_end_str
        if f.count_leading_contained(seq) >= f.k:
            return ref + ins
    return None


class FindSmallCleanInsertion(Observer):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.gap_stretch_size == f.k - 1:
            kmer_begin_str = f.to_string(f.kmer_begin.fwd)
            kmer_end_str = f.to_string(f.kmer_end.fwd)
            ref = kmer_begin_str[-1]
            alt = _micro_assembly(f, kmer_begin_str, kmer_end_str, ref)
            if alt is None:
                return False
            f.write_indel(f.breakpoint_id, f.chrom_name, f.position - 2, ref, alt, 0, STR_HOM_TYPE)
            f.stats.homo_clean_indel += 1
            f.breakpoint_id_iterate()
            return True
        return False


class FindSmallFuzzyInsertion(Observer):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.k - 1 - f.max_repeat <= f.gap_stretch_size < f.k - 1:
            repeat_size = f.k - 1 - int(f.gap_stretch_size)
            kmer_begin_str = f.to_string(f.kmer_begin.fwd)
            kmer_end_str = f.chrom_seq[f.position - 1 + repeat_size : f.position - 1 + repeat_size + f.k]
            if (
                f.nb_out_branch(f.kmer_begin.fwd) == 0
                or f.nb_in_branch(f.kmer_end.fwd) == 0
                or not f.code_seed_valid(f.chrom_seq[f.position - 1 + repeat_size :])
            ):
                return False
            ref = kmer_begin_str[len(kmer_begin_str) - 1 - repeat_size]
            alt = _micro_assembly(f, kmer_begin_str, kmer_end_str, ref)
            if alt is None:
                return False
            f.write_indel(
                f.breakpoint_id, f.chrom_name, f.position - 2, ref, alt, repeat_size, STR_HOM_TYPE
            )
            f.stats.homo_clean_indel += 1  # reference bumps the clean counter here too
            f.breakpoint_id_iterate()
            return True
        return False


# ---------------------------------------------------------------------------
# Homozygous insertion breakpoints (src/FindInsertion.hpp)
# ---------------------------------------------------------------------------
class FindCleanInsertion(Observer):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.gap_stretch_size == f.k - 1:
            kmer_begin_str = f.to_string(f.kmer_begin.fwd)
            kmer_end_str = f.to_string(f.kmer_end.fwd)
            if f.nb_out_branch(f.kmer_begin.fwd) == 0 or f.nb_in_branch(f.kmer_end.fwd) == 0:
                return False
            f.write_breakpoint(
                f.breakpoint_id, f.chrom_name, f.position - 2,
                kmer_begin_str, kmer_end_str, 0, STR_HOM_TYPE,
                f.kmer_begin_is_repeated, f.kmer_end_is_repeated,
            )
            f.breakpoint_id_iterate()
            f.stats.homo_clean += 1
            return True
        return False


class FindFuzzyInsertion(Observer):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.k - 1 - f.max_repeat <= f.gap_stretch_size < f.k - 1:
            repeat_size = f.k - 1 - int(f.gap_stretch_size)
            kmer_begin_str = f.to_string(f.kmer_begin.fwd)
            kmer_end_str = f.chrom_seq[f.position - 1 + repeat_size : f.position - 1 + repeat_size + f.k]
            if (
                f.nb_out_branch(f.kmer_begin.fwd) == 0
                or f.nb_in_branch(f.kmer_end.fwd) == 0
                or not f.code_seed_valid(f.chrom_seq[f.position - 1 + repeat_size :])
            ):
                return False
            f.write_breakpoint(
                f.breakpoint_id, f.chrom_name, f.position - 2 + repeat_size,
                kmer_begin_str, kmer_end_str, repeat_size, STR_HOM_TYPE,
                f.kmer_begin_is_repeated, f.kmer_end_is_repeated,
            )
            f.breakpoint_id_iterate()
            f.stats.homo_fuzzy += 1
            return True
        return False


# ---------------------------------------------------------------------------
# Backup (src/FindBackup.hpp, off by default)
# ---------------------------------------------------------------------------
class FindBackup(Observer):
    def update(self) -> bool:
        f = self.f
        if not (f.kmer_begin.valid and f.kmer_end.valid):
            return False
        if f.gap_stretch_size > f.k // 2:
            kmer_begin_str = f.to_string(f.kmer_begin.fwd)
            kmer_end_str = f.to_string(f.kmer_end.fwd)
            chrom_name_bak = f.chrom_name + "_backup"
            f.write_breakpoint(
                f.breakpoint_id, chrom_name_bak, f.position - 1,
                kmer_begin_str, kmer_end_str, 0, STR_BKP_TYPE,
            )
            f.breakpoint_id_iterate()
            f.stats.backup += 1
            return True
        return False


# ---------------------------------------------------------------------------
# Heterozygous insertions — a kmer observer (src/FindHeteroInsertion.hpp)
# ---------------------------------------------------------------------------
class FindHeteroInsertion(Observer):
    def update(self) -> bool:
        f = self.f
        if f.homo_only:
            return False

        branching_threshold = f.branching_threshold
        max_branching_kmers = branching_threshold
        filtering = True
        if branching_threshold < 0:
            filtering = False
            max_branching_kmers = 100
        filter_window_size = 100

        if not f.kmer_end_is_repeated and f.current_info.nb_in == 2 and not f.recent_hetero:
            for i in range(0, f.max_repeat + 1):
                found_base_one = False
                hist_i = f.history[(f.het_kmer_begin_index + i) % 256]
                if hist_i.nb_out == 2 and not hist_i.is_repeated:
                    kmer_begin_str = f.to_string(hist_i.kmer)
                    kmer_end_str = f.chrom_seq[f.position + i : f.position + i + f.k]
                    ref = kmer_begin_str[len(kmer_begin_str) - 1 - i]

                    if not f.code_seed_valid(f.chrom_seq[f.position + i :]):
                        return False

                    alt = None
                    for ins in NUCLEO_1_2:
                        seq = kmer_begin_str + ins + kmer_end_str
                        if f.count_leading_contained(seq) >= f.k:
                            alt = ref + ins
                            found_base_one = True
                            break
                    if found_base_one:
                        f.write_indel(
                            f.breakpoint_id, f.chrom_name, f.position - 1, ref, alt, i, STR_HET_TYPE
                        )
                        f.stats.hetero_indel += 1
                        f.breakpoint_id_iterate()
                        return True
                    else:
                        # maybe a large insertion: apply the branching filter
                        nb_branching = 0
                        if filtering:
                            nb_prev = 0
                            begin_index = (f.het_kmer_begin_index - 1) % 256
                            while nb_branching <= max_branching_kmers and nb_prev < filter_window_size:
                                h = f.history[(begin_index - nb_prev) % 256]
                                if h.nb_out > 1 or h.nb_in > 1:
                                    nb_branching += 1
                                nb_prev += 1

                        if nb_branching <= max_branching_kmers:
                            f.write_breakpoint(
                                f.breakpoint_id, f.chrom_name, f.position - 1 + i,
                                kmer_begin_str, kmer_end_str, i, STR_HET_TYPE,
                                hist_i.is_repeated, f.kmer_end_is_repeated,
                            )
                            f.breakpoint_id_iterate()
                            if i == 0:
                                f.stats.hetero_clean += 1
                            else:
                                f.stats.hetero_fuzzy += 1
                            f.recent_hetero = f.max_repeat
                            return True
                        else:
                            f.recent_hetero = max(0, f.recent_hetero - 1)
                            return False

        f.recent_hetero = max(0, f.recent_hetero - 1)
        return False
