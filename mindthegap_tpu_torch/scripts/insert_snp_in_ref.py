"""Integrate SNPs (e.g. GATK HaplotypeCaller calls) into a reference genome
before running `MindTheGap find` — equivalent of the reference's
scripts/python3/Inser_snp_in_ref.py (documented in its README.txt), built on
this package's IO instead of Biopython. Host only.

Usage: python -m mindthegap_tpu_torch.scripts.insert_snp_in_ref -s GATK.vcf -g reference.fa -o altered.fa
"""

import getopt
import sys

from ..io.bank import Bank

ALLOWED = set("ATCGatcg")


def load_snps(vcf_path):
    """chrom -> {pos0: (ref, alt)} for biallelic SNPs with ACGT alleles."""
    snps = {}
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.rstrip("\n").split("\t")
            if len(p) < 5:
                continue
            chrom, pos, _id, ref, alt = p[0], p[1], p[2], p[3], p[4]
            if len(ref) != 1 or len(alt) != 1:
                continue
            if ref not in ALLOWED or alt not in ALLOWED:
                continue
            snps.setdefault(chrom, {})[int(pos) - 1] = (ref.upper(), alt.upper())
    return snps


def main(argv):
    opts, _args = getopt.getopt(argv, "s:g:o:", ["snp=", "genome=", "genome_altered="])
    vcf = genome = out = None
    for opt, arg in opts:
        if opt in ("-s", "--snp"):
            vcf = arg
        elif opt in ("-g", "--genome"):
            genome = arg
        elif opt in ("-o", "--genome_altered"):
            out = arg
    if not (vcf and genome and out):
        print(__doc__)
        return 2

    snps = load_snps(vcf)
    applied = 0
    skipped = 0
    with open(out, "w") as fo:
        for rec in Bank.open(genome):
            seq = list(rec.seq)
            for pos, (ref, alt) in snps.get(rec.comment_short, {}).items():
                if 0 <= pos < len(seq) and seq[pos].upper() == ref:
                    seq[pos] = alt
                    applied += 1
                else:
                    skipped += 1
            fo.write(">%s\n%s\n" % (rec.comment, "".join(seq)))
    print(f"applied {applied} SNPs, skipped {skipped} (ref mismatch / out of range)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
