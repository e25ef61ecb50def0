"""Algorithm constants of the variant-assignment engine.

These mirror the reference tool's hard-coded scoring parameters
(reference src/main.rs:27-38) — they are part of the observable
behavior (they decide ref/alt/unknown calls), not tunables.
"""

# Call codes.
REF_VALUE = 1
ALT_VALUE = 2
REF_ALT_VALUE = 3
UNKNOWN_VALUE = -1

# A read whose best local-alignment score against BOTH haplotypes is below
# this is dropped entirely (reference src/main.rs:1019-1022).
MIN_SCORE = 25

# Per-UMI consensus threshold (reference src/main.rs:32; the README says 90%
# but the code says 0.75 — the code is ground truth).
CONSENSUS_THRESHOLD = 0.75

# Smith-Waterman affine-gap local alignment scoring. A gap of length L costs
# GAP_OPEN + L * GAP_EXTEND (rust-bio convention, so a 1-base gap costs -6).
MATCH = 1
MISMATCH = -5
GAP_OPEN = -5
GAP_EXTEND = -1

# Banding parameters of the reference aligner (kmer seed length / band width,
# reference src/main.rs:33-34). Our kernel computes full (unbanded) SW, which
# is exact; these are kept for the banded oracle used in parity testing.
K = 6
W = 20

# Base encoding used on device: A=0 C=1 G=2 T=3, anything else = 4 (N etc.).
# Read padding uses PAD_X and haplotype padding PAD_Y; they differ from each
# other and from all real codes so padded cells can never match (score -5),
# which keeps padded DP exact (all transitions into pad regions are negative).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_OTHER = 0, 1, 2, 3, 4
PAD_X = 5
PAD_Y = 6

# Large negative sentinel for DP initialisation; int32-safe under repeated
# GAP_EXTEND additions.
NEG_INF = -(1 << 28)
