"""The analysis scripts of the reference's scripts/python3 directory, over
this package: context_genome_wg (a breakpoint filter by k-mer connectivity)
and insert_snp_in_ref (SNPs written into a reference). Each runs as
`python -m mindthegap_tpu_torch.scripts.<name>`."""
