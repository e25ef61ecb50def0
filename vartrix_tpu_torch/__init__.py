"""vartrix_tpu_torch — single-cell variant assignment on PyTorch and CUDA.

VCF + BAM or CRAM + FASTA + cell barcodes -> sparse variants x cells
matrices, with
the read-vs-haplotype Smith-Waterman scores computed by a hand-written CUDA
kernel (csrc/sw_pair.cu). Writes the same .mtx files as vartrix_tpu.
"""

__version__ = "0.1.0"
