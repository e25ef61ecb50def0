#!/usr/bin/env python3
"""GPU smoke check of vartrix_tpu_torch, the PyTorch/CUDA package.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. card and toolchain: name and power limit (nvidia-smi), torch, CUDA;
  2. build: the CUDA pair kernel (nvcc) and libgenomio (g++) from the
     checkout's sources, in parallel, with the compiler's register report;
  3. kernel against its plain PyTorch version on the card, exact equality,
     dense and 2-bit reads, int32 scores and int8 call codes, over the
     shape families of the default path, and one read long enough to take
     the scratch word near its 16-bit limit;
  4. timing at the main bucket shape (lx=160, ly=224, 131,072 pairs) with
     CUDA events: the kernel, the plain version, and the bound, from the
     instructions per cell in the kernel's SASS (cuobjdump) at the card's
     instruction issue rate;
  5. end to end: a seeded 500,000-read dataset through the driver with
     --backend cuda in the three scoring modes, each repeated with
     --backend torch; matrices must agree, the kernel must have launched on
     the cuda runs and never on the torch runs. The CLI entry
     (python -m vartrix_tpu_torch) runs once on a small dataset.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import collections
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12
# instruction issue per SM and clock on Hopper: 4 schedulers, each one warp
# instruction (32 threads) per clock, whatever pipe the instruction uses
ISSUE_PER_SM_CLK = 4 * 32
# the instantiation the main path launches: 2-bit reads, int8 call codes
MAIN_KERNEL_SYMBOL = "sw_pair_kernelILb1ELb1E"
MAIN_LX, MAIN_LY, MAIN_READS = 160, 224, 65536
E2E_CFG = dict(n_chroms=4, chrom_len=200_000, n_variants=1000, n_cells=2000,
               reads_per_variant=500, spliced_frac=0.5, seed=100)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------- inputs


def make_family(rng, n_reads, lx, ly, *, read_len, hap_len, err=0.01,
                indels=False, empty_frac=0.0, odd_bytes=False):
    """Seeded reads sampled from haplotype pairs (alt = ref with one
    substitution), with sequencing errors. Returns (x uint8 [R, lx] pad 0,
    haps uint8 [H, ly] pad 1, idx_ref, idx_alt int32 [R])."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    n_var = max(1, n_reads // 64)
    hl = rng.integers(hap_len[0], hap_len[1] + 1, n_var)
    ref = rng.choice(bases, (n_var, ly))
    alt = ref.copy()
    snv = hl // 2
    alt[np.arange(n_var), snv] = bases[(np.searchsorted(
        bases, ref[np.arange(n_var), snv]) + 1) % 4]
    haps = np.ones((2 * n_var, ly), np.uint8)
    cols = np.arange(ly)[None, :]
    haps[0::2] = np.where(cols < hl[:, None], ref, 1)
    haps[1::2] = np.where(cols < hl[:, None], alt, 1)
    if empty_frac:
        haps[rng.random(2 * n_var) < empty_frac] = 1
    if odd_bytes:  # raw-byte compare: lowercase haplotype bases
        low = (rng.random(haps.shape) < 0.02) & (haps != 1)
        haps[low] = haps[low] + 32
    var = rng.integers(0, n_var, n_reads)
    src = 2 * var + rng.integers(0, 2, n_reads)
    L = np.minimum(rng.integers(read_len[0], read_len[1] + 1, n_reads),
                   np.minimum(hl[var], lx))
    L = np.maximum(L, 1)
    off = (rng.random(n_reads) * (hl[var] - L + 1)).astype(np.int64)
    pos = np.minimum(off[:, None] + np.arange(lx)[None, :], ly - 1)
    x = haps[src[:, None], pos]
    x = np.where(x == 1, bases[0], x)  # reads of empty haplotypes
    x = np.where((x >= 97), x - 32, x)  # reads are uppercase
    errs = rng.random(x.shape) < err
    x[errs] = rng.choice(bases, int(errs.sum()))
    if odd_bytes:
        x[rng.random(x.shape) < 0.01] = ord("N")
        x[rng.random(x.shape) < 0.01] = ord("=")
    x[np.arange(lx)[None, :] >= L[:, None]] = 0
    if indels:
        for i in range(n_reads):
            row = list(x[i, : L[i]])
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(1, max(2, len(row) - 1)))
                if rng.random() < 0.5:
                    del row[p : p + int(rng.integers(1, 5))]
                else:
                    row[p:p] = list(rng.choice(bases, int(rng.integers(1, 5))))
            row = row[:lx]
            x[i] = 0
            x[i, : len(row)] = row
    idx_ref = (2 * var).astype(np.int32)
    idx_alt = (2 * var + 1).astype(np.int32)
    return x, haps, idx_ref, idx_alt


def mixed_gap_family():
    """Adversarial gap corners: one read base against t haplotype bases."""
    import numpy as np

    cases = []
    for flank in (6, 10, 14):
        for ins in (1, 2, 3):
            a = b"A" * flank + b"C" + b"G" * flank
            b = b"A" * flank + b"T" * (ins + 1) + b"G" * flank
            cases += [(a, b), (b, a)]
    lx, ly = 48, 64
    x = np.zeros((len(cases), lx), np.uint8)
    haps = np.ones((2 * len(cases), ly), np.uint8)
    for i, (a, b) in enumerate(cases):
        x[i, : len(a)] = np.frombuffer(a, np.uint8)
        haps[2 * i, : len(b)] = np.frombuffer(b, np.uint8)
        haps[2 * i + 1, : len(a)] = np.frombuffer(a, np.uint8)
    idx = np.arange(len(cases), dtype=np.int32)
    return x, haps, 2 * idx, 2 * idx + 1


def pack2(x):
    """uint8 [R, lx] A/C/G/T reads -> (uint8 [R, lx//4], int32 [R])."""
    import numpy as np

    lut = np.zeros(256, np.uint8)
    for c, b in enumerate(b"ACGT"):
        lut[b] = c
    codes = lut[x]
    out = np.zeros((x.shape[0], x.shape[1] // 4), np.uint8)
    for k in range(4):
        out |= codes[:, k::4] << (2 * k)
    return out, (x != 0).sum(1).astype(np.int32)


def true_cells(x, haps, idx_ref, idx_alt, strip=1):
    """Sum over (read, haplotype) pairs of true read length (rounded up to
    `strip` rows) x true haplotype length."""
    import numpy as np

    lx_true = (x != 0).sum(1).astype(np.int64)
    lx_true = (lx_true + strip - 1) // strip * strip
    h_true = (haps != 1).sum(1).astype(np.int64)
    return int((lx_true * (h_true[idx_ref] + h_true[idx_alt])).sum())


def near_limit_family(rng):
    """One read of 32,842 bases against a 32,840-base haplotype it copies
    with a 2-base insertion that spans a 16-row strip boundary after 32,783
    matched bases, so F near the top of the scratch word's range crosses
    the boundary. The alt haplotype has one substitution at base 100.
    Scores are known: n - 7 (ref) and n - 13 (alt)."""
    import numpy as np

    n, p = 32840, 16 * 2049 - 1
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, n)
    read = np.concatenate([hap[:p], np.frombuffer(b"AC", np.uint8), hap[p:]])
    alt = hap.copy()
    alt[100] = bases[(np.searchsorted(bases, alt[100]) + 1) % 4]
    idx = np.zeros(1, np.int32)
    return read[None, :], np.stack([hap, alt]), idx, idx + 1, [n - 7, n - 13]


# ---------------------------------------------------------------- phases


def phase_card():
    """(name and power limit as nvidia-smi prints them, max SM clock Hz)."""
    import torch

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.splitlines()[0].strip()

    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"card: {card}, max SM clock {clock_mhz:.0f} MHz")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return card, clock_mhz * 1e6


def phase_build():
    from vartrix_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        kern = ex.submit(_build.kernel_library)
        gio = ex.submit(_build.genomio_library)
        kern_path, gio_path = kern.result(), gio.result()
    log(f"build: sw_pair.cu + genomio.cpp in {time.perf_counter() - t0:.2f}s")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"  nvcc: {nvcc[-1]}")
    for line in _build.build_log(kern_path).splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"  ptxas: {line.strip()}")
    return kern_path, gio_path


def phase_sass(kern_path):
    """Instructions the compiled kernel issues per DP cell, read from the
    SASS of the main instantiation's hot loop: the innermost loop holding
    the most three-way H maxima (VIMNMX3.RELU, one per cell)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = (shutil.which("cuobjdump")
            or os.path.join(cuda_home, "bin", "cuobjdump"))
    sass = subprocess.run([tool, "-sass", kern_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = [f for f in funcs if f.startswith("_Z") and MAIN_KERNEL_SYMBOL in f]
    if len(body) != 1:
        fail(f"cuobjdump shows no single {MAIN_KERNEL_SYMBOL} function")
    instrs = [(int(a, 16), op.strip()) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body[0])]
    loops = []
    for addr, op in instrs:
        m = re.search(r"\bBRA 0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            loop = [o for a, o in instrs if int(m.group(1), 16) <= a <= addr]
            cells = sum("VIMNMX3.RELU" in o for o in loop)
            loops.append((-cells, len(loop), loop))
    if not loops or min(loops)[0] == 0:
        fail("no DP loop found in the kernel's SASS")
    neg_cells, n_instr, loop = min(loops)
    cells = -neg_cells
    opcodes = collections.Counter(
        re.sub(r"^@!?U?P\w+\s+", "", o).split()[0] for o in loop)
    log(f"sass: {MAIN_KERNEL_SYMBOL} hot loop: {n_instr} instructions for "
        f"{cells} cells = {n_instr / cells:.4f} per cell; opcodes "
        + ", ".join(f"{k} {v}" for k, v in opcodes.most_common()))
    return n_instr / cells


def phase_equality(rng):
    """Kernel against plain version on every family; returns max |err|."""
    import numpy as np
    import torch

    from vartrix_tpu_torch.ops import sw_cuda, sw_torch

    families = {
        "main": make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                            read_len=(140, 150), hap_len=(180, 224)),
        "indel_heavy": make_family(rng, 4096, 64, 96, read_len=(40, 64),
                                   hap_len=(60, 96), err=0.03, indels=True),
        "empty_haps": make_family(rng, 2048, 48, 64, read_len=(20, 48),
                                  hap_len=(30, 64), empty_frac=0.2),
        "odd_r_301": make_family(rng, 301, 32, 48, read_len=(8, 32),
                                 hap_len=(20, 48)),
        "ly_4032": make_family(rng, 4096, 160, 4032, read_len=(140, 150),
                               hap_len=(3800, 4032)),
        "mixed_gap": mixed_gap_family(),
        "n_eq_lower": make_family(rng, 4096, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224),
                                  odd_bytes=True),
    }
    worst = 0
    for name, (x, haps, ir, ia) in families.items():
        xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
        plain = sw_torch.pair_scores(xt, ht, irt, iat)
        plain_codes = sw_torch.calls_from_scores(plain)
        forms = [("dense", xt, None)]
        if np.isin(x[x != 0], np.frombuffer(b"ACGT", np.uint8)).all():
            xp, lens = pack2(x)
            forms.append(("2bit", torch.from_numpy(xp).cuda(),
                          torch.from_numpy(lens).cuda()))
        for form, reads, lens in forms:
            got = sw_cuda.pair_scores(reads, ht, irt, iat, read_lens=lens)
            codes = sw_cuda.pair_calls(reads, ht, irt, iat, read_lens=lens)
            torch.cuda.synchronize()
            err = int((got - plain).abs().max().item()) if len(x) else 0
            bad = int((codes != plain_codes).sum().item())
            worst = max(worst, err)
            log(f"kernel {name:11s} {form:5s} R={len(x)} lx={x.shape[1]} "
                f"ly={haps.shape[1]}: max|err|={err} code mismatches={bad}")
            if err or bad:
                fail(f"kernel disagrees with the plain version on {name} "
                     f"({form})")
        if name == "ly_4032":
            wide = (x, haps, ir, ia)
    # near the scratch word's limit: dense scores, against the plain version
    # and the known scores
    x, haps, ir, ia, known = near_limit_family(rng)
    xt, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    got = sw_cuda.pair_scores(xt, ht, irt, iat)[:, 0].tolist()
    plain = sw_torch.pair_scores(xt, ht, irt, iat)[:, 0].tolist()
    log(f"kernel near_limit  dense R=1 lx={x.shape[1]} ly={haps.shape[1]}: "
        f"kernel {got}, plain {plain}, known {known}")
    if not got == plain == known:
        fail("kernel disagrees near the scratch word's limit")
    worst = max(worst, *(abs(a - b) for a, b in zip(got, plain)))
    # the plain (x, y) call: the same kernel with identity indices
    x, haps, ir, ia = wide
    xt = torch.from_numpy(x).cuda()
    yt = torch.from_numpy(haps[ir]).cuda()
    got = sw_cuda.batch_scores(xt, yt)
    exp = sw_torch.sw_scores(xt, yt)
    err = int((got - exp).abs().max().item())
    log(f"kernel batch rows  dense B={len(x)} ly={haps.shape[1]}: "
        f"max|err|={err}")
    if err:
        fail("batch_scores disagrees with the plain version")
    return worst


def time_cuda(fn, warmup, reps):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_timing(rng, instr_per_cell, clock_hz):
    """Kernel and plain times at the main bucket shape, and the bound: the
    needed cells x the instructions the compiled hot loop issues per cell,
    over the card's instruction issue rate (every instruction issues once,
    whatever pipe runs it), against the bytes over HBM bandwidth."""
    import torch

    from vartrix_tpu_torch.ops import sw_cuda, sw_torch

    x, haps, ir, ia = make_family(rng, MAIN_READS, MAIN_LX, MAIN_LY,
                                  read_len=(140, 150), hap_len=(180, 224))
    xp, lens = pack2(x)
    _, ht, irt, iat = sw_cuda.from_numpy(x, haps, ir, ia, "cuda")
    xpt = torch.from_numpy(xp).cuda()
    lt = torch.from_numpy(lens).cuda()
    ms = time_cuda(lambda: sw_cuda.pair_calls(xpt, ht, irt, iat,
                                              read_lens=lt), 3, 15)
    plain_ms = time_cuda(lambda: sw_torch.pair_calls(xpt, ht, irt, iat,
                                                     read_lens=lt), 1, 3)
    cells = true_cells(x, haps, ir, ia)
    computed = true_cells(x, haps, ir, ia, strip=16)
    padded = 2 * MAIN_READS * MAIN_LX * MAIN_LY
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = sms * ISSUE_PER_SM_CLK * clock_hz
    ops = cells * instr_per_cell
    ops_ms = ops / issue_per_s * 1e3
    nbytes = (xp.nbytes + lens.nbytes + haps.nbytes + ir.nbytes + ia.nbytes
              + MAIN_READS)  # inputs read once, int8 codes written once
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"timing sw_pair at lx={MAIN_LX} ly={MAIN_LY}, {2 * MAIN_READS} pairs "
        f"(2-bit reads, int8 codes): {ms:.4f} ms "
        f"({cells / ms / 1e6:.1f} G needed cells/s); plain {plain_ms:.3f} ms")
    log(f"timing bound: {cells} needed cells (the kernel computes "
        f"{computed} in whole 16-row strips; {padded} padded) x "
        f"{instr_per_cell:.4f} instructions per cell (SASS) / ({sms} SMs x "
        f"{ISSUE_PER_SM_CLK} per clock x {clock_hz / 1e9:.3f} GHz = "
        f"{issue_per_s:.6g} instructions/s) = {ops_ms:.4f} ms; {nbytes} "
        f"bytes / {HBM_BYTES_PER_S:.3g} B/s = {bytes_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f} % of the kernel's "
        f"time; library_ms null: no PyTorch call computes Smith-Waterman")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def read_mtx(path):
    """(shape, {(row, col): value}) of a Matrix Market file."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if not ln.startswith("%")]
    r, c, _ = (int(v) for v in lines[0].split())
    entries = {}
    for ln in lines[1:]:
        i, j, v = ln.split()
        key = (int(i), int(j))
        entries[key] = entries.get(key, 0.0) + float(v)
    return (r, c), entries


def csr_equal(a, b):
    (sa, ea), (sb, eb) = read_mtx(a), read_mtx(b)
    if sa != sb or ea.keys() != eb.keys():
        return False
    return all(ea[k] == eb[k] or (math.isnan(ea[k]) and math.isnan(eb[k]))
               for k in ea)


def phase_e2e(work):
    from vartrix_tpu_torch import driver
    from vartrix_tpu_torch.ops import sw_cuda
    from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

    t0 = time.perf_counter()
    data = generate_dataset(os.path.join(work, "e2e"), SynthConfig(**E2E_CFG))
    n_reads = data["n_reads"]
    log(f"e2e: generated {n_reads} reads in {time.perf_counter() - t0:.1f}s")
    modes = {"consensus": ["-s", "consensus"],
             "coverage_umi": ["-s", "coverage", "--umi"],
             "alt_frac": ["-s", "alt_frac"]}
    backends = {"cuda": ["--backend", "cuda"],
                "torch": ["--backend", "torch", "--device", "cuda"]}
    outs = {}
    launches = {}
    for be, be_args in backends.items():
        sw_cuda.LAUNCHES = 0
        for mode, mode_args in modes.items():
            tag = f"{mode}_{be}"
            out = os.path.join(work, f"{tag}.mtx")
            ref = os.path.join(work, f"{tag}_ref.mtx")
            mj = os.path.join(work, f"{tag}.json")
            argv = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
                    "-c", data["barcodes"], "-o", out, "--ref-matrix", ref,
                    "--threads", str(os.cpu_count() or 1),
                    "--metrics-json", mj] + mode_args + be_args
            t0 = time.perf_counter()
            driver._main(argv)
            dt = time.perf_counter() - t0
            with open(mj) as f:
                payload = json.load(f)
            shape = payload["matrix"]["shape"]
            if shape != [E2E_CFG["n_variants"], E2E_CFG["n_cells"]]:
                fail(f"{tag}: matrix shape {shape}")
            log(f"e2e {tag}: {dt:.3f}s, {n_reads / dt:.0f} reads/s, nnz "
                f"{payload['matrix']['nnz']}, launches "
                f"{payload['kernel_launches']['sw_pair']}, phases "
                f"{payload['phase_seconds']}")
            outs[tag] = (out, ref)
        launches[be] = sw_cuda.LAUNCHES
    log(f"e2e: sw_pair launches over the cuda runs {launches['cuda']}, "
        f"over the torch runs {launches['torch']}")
    if launches["cuda"] <= 0:
        fail("the --backend cuda runs never launched the kernel")
    if launches["torch"] != 0:
        fail("the --backend torch runs launched the kernel")
    for mode in modes:
        a, b = outs[f"{mode}_cuda"], outs[f"{mode}_torch"]
        ok = csr_equal(a[0], b[0])
        if mode == "coverage_umi":
            ok = ok and csr_equal(a[1], b[1])
        log(f"e2e {mode}: cuda == torch (CSR, NaN-aware): {ok}")
        if not ok:
            fail(f"{mode}: the kernel's matrices differ from the plain "
                 "version's")
    return launches["cuda"]


def phase_cli(work):
    """The user's entry point on a small dataset, against the plain
    version on the CPU."""
    from vartrix_tpu_torch.utils.synth import SynthConfig, generate_dataset

    data = generate_dataset(os.path.join(work, "small"), SynthConfig(
        n_variants=8, n_cells=25, reads_per_variant=25, seed=77,
        spliced_frac=0.3, indel_frac=0.2))
    base = ["-v", data["vcf"], "-b", data["bam"], "-f", data["fasta"],
            "-c", data["barcodes"], "-s", "alt_frac", "--ref-matrix",
            os.path.join(work, "cli_ref.mtx")]
    out_gpu = os.path.join(work, "cli_gpu.mtx")
    out_cpu = os.path.join(work, "cli_cpu.mtx")
    for out, extra in ((out_gpu, []),
                       (out_cpu, ["--device", "cpu", "--backend", "torch"])):
        subprocess.run([sys.executable, "-m", "vartrix_tpu_torch", *base,
                        "-o", out, *extra], cwd=HERE, check=True, timeout=300)
    with open(out_gpu, "rb") as f, open(out_cpu, "rb") as g:
        same = f.read() == g.read()
    log(f"cli: python -m vartrix_tpu_torch on the card == plain on the CPU "
        f"(bytes): {same}")
    if not same:
        fail("the CLI's kernel run differs from the CPU plain run")


def main():
    if not os.path.exists(os.path.join(HERE, "vartrix_tpu_torch",
                                       "__init__.py")):
        fail("run from a checkout of the repository: vartrix_tpu_torch/ "
             "is missing")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    card, clock_hz = phase_card()
    kern_path, _ = phase_build()
    instr_per_cell = phase_sass(kern_path)
    rng = np.random.default_rng(2024)
    worst = phase_equality(rng)
    timing = phase_timing(rng, instr_per_cell, clock_hz)
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        launches = phase_e2e(work)
        phase_cli(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"sw_pair: {timing['ms']:.4f} ms, plain {timing['plain_ms']:.3f} ms, "
        f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}), "
        f"library_ms null, {launches} launches on the main path")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    record = {"kernels": [{
        "name": "sw_pair", "route": "cuda",
        "source": "vartrix_tpu_torch/csrc/sw_pair.cu",
        "replaces": "vartrix_tpu/ops/sw_pallas_v2.py:55 (K1), :795 (K2), "
                    ":1325 (K3)",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes Smith-Waterman",
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
