"""Synthetic workload generation: FASTA + VCF + barcodes + BAM datasets
with known ground truth, for benchmarks and large-scale tests.

Reads are sampled from per-cell genotypes (ref/ref, ref/alt, alt/alt) with
sequencing errors, so the expected consensus matrix is known and the
workload exercises the same score distributions as real data.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.bam_writer import encode_record, write_bam

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class SynthConfig:
    n_chroms: int = 2
    chrom_len: int = 100_000
    n_variants: int = 100
    n_cells: int = 200
    reads_per_variant: int = 100
    read_len: int = 150
    error_rate: float = 0.005
    indel_frac: float = 0.1
    max_indel: int = 8
    umi: bool = True
    seed: int = 0
    # uniform genome-wide coverage reads that mostly DON'T touch variants —
    # models whole-genome BAMs with sparse VCFs (the indexed region-fetch
    # scenario; the reference's per-variant bam.fetch never decodes these)
    background_reads: int = 0
    # fraction of variant reads whose CIGAR is N-split (spliced) — real
    # 10x scRNA is dominated by these; they exercise the multi-interval
    # useful-overlap path instead of the single-interval fast path
    spliced_frac: float = 0.04


def generate_dataset(outdir: str, cfg: SynthConfig) -> dict:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)

    # --- genome ---
    chroms = [f"chr{i+1}" for i in range(cfg.n_chroms)]
    genome = {c: rng.choice(BASES, cfg.chrom_len).astype(np.uint8) for c in chroms}
    fasta_path = os.path.join(outdir, "genome.fa")
    with open(fasta_path, "wb") as f, open(fasta_path + ".fai", "wt") as fi:
        offset = 0
        for c in chroms:
            hdr = f">{c}\n".encode()
            f.write(hdr)
            offset += len(hdr)
            seq = genome[c].tobytes()
            for i in range(0, len(seq), 60):
                f.write(seq[i : i + 60] + b"\n")
            fi.write(f"{c}\t{len(seq)}\t{offset}\t60\t61\n")
            offset += len(seq) + len(seq) // 60 + (1 if len(seq) % 60 else 0)

    # --- variants: grid placement (spacing 2*read_len) with jitter, so
    # reads overlap exactly one variant and placement is O(n) ---
    # spacing covers 2*read_len separation even after jitter (< read_len/2)
    spacing = 2 * cfg.read_len + cfg.read_len // 2 + 2 * cfg.max_indel
    margin = cfg.read_len + cfg.max_indel
    slots = []
    for ci in range(cfg.n_chroms):
        p = margin
        while p < cfg.chrom_len - margin - spacing:
            slots.append((ci, p))
            p += spacing
    if len(slots) < cfg.n_variants:
        raise ValueError(
            f"genome too small for {cfg.n_variants} variants "
            f"({len(slots)} slots); increase chrom_len or n_chroms")
    rng.shuffle(slots)
    variants = []  # (chrom_idx, pos0, ref bytes, alt bytes)
    for ci, slot_pos in slots[: cfg.n_variants]:
        pos = slot_pos + int(rng.integers(0, cfg.read_len // 2))
        g = genome[chroms[ci]]
        r = rng.random()
        if r < 1 - cfg.indel_frac:  # SNV
            ref = g[pos : pos + 1].tobytes()
            alt = BASES[(int(np.searchsorted(BASES, ref[0])) + int(rng.integers(1, 4))) % 4 :][:1].tobytes()
            if alt == ref:
                alt = BASES[(BASES.tolist().index(ref[0]) + 1) % 4 :][:1].tobytes()
        elif r < 1 - cfg.indel_frac / 2:  # deletion
            dl = int(rng.integers(1, cfg.max_indel + 1))
            ref = g[pos : pos + dl + 1].tobytes()
            alt = ref[:1]
        else:  # insertion
            il = int(rng.integers(1, cfg.max_indel + 1))
            ref = g[pos : pos + 1].tobytes()
            alt = ref + rng.choice(BASES, il).astype(np.uint8).tobytes()
        variants.append((ci, pos, ref, alt))
    variants.sort(key=lambda v: (v[0], v[1]))

    vcf_path = os.path.join(outdir, "variants.vcf")
    with open(vcf_path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        for c in chroms:
            f.write(f"##contig=<ID={c},length={cfg.chrom_len}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for ci, pos, ref, alt in variants:
            f.write(f"{chroms[ci]}\t{pos + 1}\t.\t{ref.decode()}\t{alt.decode()}\t.\t.\t.\n")

    # --- cells + genotypes ---
    bc_pool = rng.choice(BASES, (cfg.n_cells, 16)).astype(np.uint8)
    barcodes = [bc_pool[i].tobytes().decode() + "-1" for i in range(cfg.n_cells)]
    bc_path = os.path.join(outdir, "barcodes.tsv")
    with open(bc_path, "wt") as f:
        f.write("\n".join(barcodes) + "\n")
    # genotype per (variant, cell): 0=ref/ref, 1=het, 2=alt/alt
    genotypes = rng.integers(0, 3, (cfg.n_variants, cfg.n_cells)).astype(np.int8)

    # --- reads ---
    records_by_coord = []
    read_id = 0
    for vi, (ci, pos, ref, alt) in enumerate(variants):
        g = genome[chroms[ci]]
        # alt chromosome segment around the variant
        lo = pos - cfg.read_len - cfg.max_indel
        hi = pos + len(ref) + cfg.read_len + cfg.max_indel
        ref_seg = g[lo:hi]
        alt_seg = np.concatenate(
            [g[lo:pos], np.frombuffer(alt, np.uint8), g[pos + len(ref) : hi]]
        )
        for _ in range(cfg.reads_per_variant):
            cell = int(rng.integers(0, cfg.n_cells))
            gt = genotypes[vi, cell]
            is_alt = bool(rng.random() < (0.0, 0.5, 1.0)[gt])
            seg = alt_seg if is_alt else ref_seg
            # read start in segment coords; ensure overlap with the locus
            start_min = max(0, (pos - lo) - cfg.read_len + 1)
            start_max = pos - lo
            s = int(rng.integers(start_min, start_max + 1))
            seq = seg[s : s + cfg.read_len].copy()
            errs = rng.random(len(seq)) < cfg.error_rate
            if errs.any():
                seq[errs] = rng.choice(BASES, int(errs.sum()))
            # map the read at its segment position on the REF coordinate
            # system (alt reads keep their nominal start; clamp into chrom)
            map_pos = lo + s
            flag = 16 if rng.random() < 0.5 else 0
            # flag/CIGAR diversity so the filter chain and overlap logic
            # are exercised differentially (python vs native hosts)
            r2 = rng.random()
            if r2 < 0.05:
                flag |= 0x400  # duplicate
            elif r2 < 0.08:
                flag |= 0x100  # secondary
            elif r2 < 0.10:
                flag |= 0x800  # supplementary
            L = len(seq)
            r3 = rng.random()
            if r3 < 0.06 and L > 40:  # leading soft clip
                sc = int(rng.integers(5, 20))
                cigar = [(4, sc), (0, L - sc)]
                map_pos += sc
            elif r3 < 0.06 + cfg.spliced_frac and L > 60:  # N-split (spliced)
                a = int(rng.integers(20, L - 20))
                cigar = [(0, a), (3, int(rng.integers(10, 50))), (0, L - a)]
            elif r3 < 0.10 + cfg.spliced_frac and L > 60:  # deletion
                a = int(rng.integers(20, L - 20))
                cigar = [(0, a), (2, int(rng.integers(1, 6))), (0, L - a)]
            else:
                cigar = [(0, L)]
            tags = [(b"CB", barcodes[cell].encode())]
            if cfg.umi:
                umi = rng.choice(BASES, 10).astype(np.uint8).tobytes()
                tags.append((b"UB", umi))
            rec = encode_record(
                qname=f"r{read_id}".encode(),
                flag=flag,
                tid=ci,
                pos=map_pos,
                mapq=int(rng.integers(0, 61)),
                cigar=cigar,
                seq=seq.tobytes(),
                tags=tags,
            )
            records_by_coord.append((ci, map_pos, rec))
            read_id += 1

    for _ in range(cfg.background_reads):
        ci = int(rng.integers(0, cfg.n_chroms))
        g = genome[chroms[ci]]
        map_pos = int(rng.integers(0, cfg.chrom_len - cfg.read_len))
        seq = g[map_pos : map_pos + cfg.read_len].copy()
        errs = rng.random(len(seq)) < cfg.error_rate
        if errs.any():
            seq[errs] = rng.choice(BASES, int(errs.sum()))
        cell = int(rng.integers(0, cfg.n_cells))
        tags = [(b"CB", barcodes[cell].encode())]
        if cfg.umi:
            tags.append((b"UB", rng.choice(BASES, 10).astype(np.uint8).tobytes()))
        rec = encode_record(
            qname=f"r{read_id}".encode(),
            flag=16 if rng.random() < 0.5 else 0,
            tid=ci,
            pos=map_pos,
            mapq=int(rng.integers(0, 61)),
            cigar=[(0, len(seq))],
            seq=seq.tobytes(),
            tags=tags,
        )
        records_by_coord.append((ci, map_pos, rec))
        read_id += 1

    records_by_coord.sort(key=lambda t: (t[0], t[1]))
    bam_path = os.path.join(outdir, "reads.bam")
    write_bam(bam_path, [(c, cfg.chrom_len) for c in chroms],
              [r for _, _, r in records_by_coord])

    return {
        "fasta": fasta_path,
        "vcf": vcf_path,
        "bam": bam_path,
        "barcodes": bc_path,
        "n_reads": read_id,
        "genotypes": genotypes,
        "variants": variants,
        "chroms": chroms,
    }


def with_n_bases(bam_path: str, out_path: str, frac: float,
                 seed: int) -> int:
    """Writes the records of the BAM at bam_path (a coordinate-sorted file
    of write_bam's, header and all) to out_path with its .bai, each read of
    a seeded `frac` of them with one base, at a seeded position, set to N:
    the share of Illumina reads that carry an N (about 1 %). Every other
    byte of a record is kept. Returns the number of reads changed."""
    import gzip
    import struct

    with open(bam_path, "rb") as f:
        stream = gzip.decompress(f.read())
    off = 8 + struct.unpack_from("<i", stream, 4)[0]
    refs = []
    for _ in range(struct.unpack_from("<i", stream, off)[0]):
        l_name = struct.unpack_from("<i", stream, off + 4)[0]
        name = stream[off + 8 : off + 7 + l_name].decode()
        length = struct.unpack_from("<i", stream, off + 8 + l_name)[0]
        refs.append((name, length))
        off += 8 + l_name
    off += 4
    records = []
    while off < len(stream):
        end = off + 4 + struct.unpack_from("<i", stream, off)[0]
        records.append(stream[off:end])
        off = end
    rng = np.random.default_rng(seed)
    picked = np.nonzero(rng.random(len(records)) < frac)[0]
    n = 0
    for i in picked.tolist():
        rec = bytearray(records[i])
        # after block_size: refID, pos, l_read_name, mapq, bin, n_cigar_op,
        # flag, l_seq, next refID, next pos, tlen; then name, CIGAR, SEQ
        n_cigar, _, l_seq = struct.unpack_from("<HHi", rec, 16)
        if l_seq <= 0:
            continue
        p = int(rng.integers(0, l_seq))
        k = 36 + rec[12] + 4 * n_cigar + p // 2
        rec[k] |= 0xF0 if p % 2 == 0 else 0x0F  # nibble 15: N
        records[i] = bytes(rec)
        n += 1
    write_bam(out_path, refs, records)
    return n
