"""Where K2-bwd's one-pass kernel spends its time, on one NVIDIA GPU.

    python3 scripts/attention_bwd_probe.py [variant ...]

Builds copies of efficient_slowfast_tpu_torch/csrc/flash_attention_bwd.cu,
each changed by text substitution, into build/attention_bwd_probe/<variant>/
(one nvcc each, in parallel), and times each with CUDA events at the four
CMDA-R50 training shapes (bf16, 8 clips of 224², N = M = 25088, 25088, 6272,
1568 with D = C = 8, 32, 64, 128), by swapping the wrapper's loaded library
(``_build._loaded["flash_attention_bwd"]``), each variant in its own process
with a time limit, in the order kernel, variants, kernel. Variants:

  kernel       the source as it is
  no_reduce    skips the dQ bulk reduce-add (dQ wrong)
  no_exp       P from an FFMA and an FMUL instead of MUFU.EX2 (all wrong)
  no_pack      P and dS to bf16 by truncation (PRMT) instead of cvt.rn
  no_ds_store  skips the dS stores to shared memory (dQ wrong)
  no_dq        skips dQ's wgmma and staging (dQ wrong)
  two_groups   two consumer warpgroups of 64 keys a block (Bc 128), one
               block an SM, at D = C = 32 and 64, with a named barrier
               between them before dQ (the split of the kernel's first
               version at those widths)
  two_blocks   one consumer warpgroup a block and two blocks an SM at
               D = C <= 32, in place of three
  stamps       the kernel with clock64() stamps at the stage boundaries of a
               tile, read by thread 0 of each consumer warpgroup and summed
               over the grid: prints the cycles per tile of each stage

Only the kernel and stamps variants compute the right gradients; the others
measure what their stage costs. Prints the card's name and power limit, and
the kernel's main loop in its SASS (the loop with the most MUFU.EX2) per
instantiation: instructions, and the most frequent opcodes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join(ROOT, "efficient_slowfast_tpu_torch", "csrc",
                   "flash_attention_bwd.cu")
OUT = os.path.join(ROOT, "build", "attention_bwd_probe")
SHAPES = [(8, 25088, 8), (8, 25088, 32), (8, 6272, 64), (8, 1568, 128)]
STAGES = ("full-wait", "S/dP", "P/dS", "dV/dK", "barrier", "dQ",
          "staging+reduce")


def sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"anchor found {text.count(old)} times: {old[:70]}")
    return text.replace(old, new)


def stamped(s):
    """The kernel with a clock64() stamp after each stage of a tile."""
    s = sub(s, "namespace {\n\nusing bf16",
            "__device__ unsigned long long g_probe[32];\n\nnamespace {\n\n"
            "using bf16")
    s = sub(s, "  hp::mbar_wait(kv_full, 0);\n\n  for (int i = 0; i < tiles; ++i) {",
            "  unsigned long long pr[8] = {0};\n  long long tp = clock64();\n"
            "  hp::mbar_wait(kv_full, 0);\n\n"
            "  for (int i = 0; i < tiles; ++i) {")
    stamp = lambda k: (f"    {{ long long t1 = clock64(); pr[{k}] += t1 - tp; "
                       "tp = t1; }\n")
    after = ["    hp::mbar_wait(&full[s], (i / P::kStages) & 1);\n",
             "    hp::fence_regs(dp);\n",
             None,
             "    hp::mbar_arrive(&empty[s]);  // q, dO and the statistics are read\n"]
    for k, anchor in enumerate(after):
        if anchor:
            s = sub(s, anchor, anchor + stamp(k))
    s = sub(s, "    // dV += P^T dO, dK += dS^T q\n",
            stamp(2) + "    // dV += P^T dO, dK += dS^T q\n")
    s = sub(s, "    hp::named_barrier(1, 128 * NWG);\n    if (wg < P::kDqWgs) {",
            "    hp::named_barrier(1, 128 * NWG);\n" + stamp(4) +
            "    if (wg < P::kDqWgs) {")
    s = sub(s, "    hp::fence_proxy_async();\n    hp::named_barrier(1, 128 * NWG);\n"
            "    if (tid == 0) {",
            stamp(5) + "    hp::fence_proxy_async();\n"
            "    hp::named_barrier(1, 128 * NWG);\n    if (tid == 0) {")
    s = sub(s, "      hp::bulk_commit();\n    }\n  }",
            "      hp::bulk_commit();\n    }\n" + stamp(6) + "  }")
    s = sub(s, "  if (tid == 0) hp::bulk_wait_read();\n\n  // dK and dV rows",
            "  if (tid % 128 == 0) {\n"
            "    for (int k = 0; k < 7; ++k) atomicAdd(&g_probe[8 * wg + k], pr[k]);\n"
            "    atomicAdd(&g_probe[8 * wg + 7], (unsigned long long)tiles);\n"
            "  }\n"
            "  if (tid == 0) hp::bulk_wait_read();\n\n  // dK and dV rows")
    return sub(s, '}  // extern "C"',
               "void probe_read(unsigned long long* h) {\n"
               "  cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n"
               "  unsigned long long z[32] = {0};\n"
               "  cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n"
               "}\n\n}  // extern \"C\"")


def variants(s):
    pack = ("pa[kk][r] = tc::pack_bf16x2(st[8 * kk + 2 * r], "
            "st[8 * kk + 2 * r + 1]);\n        da[kk][r] = "
            "tc::pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);")
    trunc = ("pa[kk][r] = __byte_perm(__float_as_uint(st[8 * kk + 2 * r]), "
             "__float_as_uint(st[8 * kk + 2 * r + 1]), 0x7632);\n        "
             "da[kk][r] = __byte_perm(__float_as_uint(dp[8 * kk + 2 * r]), "
             "__float_as_uint(dp[8 * kk + 2 * r + 1]), 0x7632);")
    return {
        "kernel": s,
        "no_reduce": sub(s, "hp::bulk_reduce_add_f32(dq_acc",
                         "if (q0 < 0) hp::bulk_reduce_add_f32(dq_acc"),
        "no_exp": sub(s, "float p = tc::ex2(fmaf(st[4 * j + e], kLog2e, -l2));",
                      "float p = fmaf(st[4 * j + e], kLog2e, -l2) * 1e-3f;"),
        "no_pack": sub(s, pack, trunc),
        "no_ds_store": sub(s, "        dss[((2 * kk + (r >> 1)) * kBc + krow + "
                           "8 * (r & 1)) * 4 + t] =\n            da[kk][r];\n",
                           ""),
        "no_dq": sub(s, "if (wg < P::kDqWgs) {  // dQ part",
                     "if (q0 < 0) {  // dQ part"),
        "two_groups": sub(sub(s, "kGroups = WP == 64 ? 2 : 1;",
                              "kGroups = WP == 32 || WP == 64 ? 2 : 1;"),
                          "kPerSm = WP <= 32 ? 3 : 1;",
                          "kPerSm = WP == 16 ? 3 : 1;"),
        "two_blocks": sub(s, "kPerSm = WP <= 32 ? 3 : 1;",
                          "kPerSm = WP <= 32 ? 2 : 1;"),
        "stamps": stamped(s),
    }


def sass_census(lib):
    """Instructions of each wgmma instantiation's main loop, by opcode."""
    import re
    from collections import Counter

    from efficient_slowfast_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for func in sass.split("Function : ")[1:]:
        name = re.search(r"attention_bwd_wgmma_kernelILi(\d+)ELi(\d)ELi(\d)E",
                         func.split("\n", 1)[0])
        if not name:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
            r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)?)([^;]*);", func)]
        loops = [(int(t.group(1), 16), a) for a, o, rest in ins
                 if o.split(".")[0] == "BRA"
                 and (t := re.search(r"0x([0-9a-f]+)", rest))
                 and int(t.group(1), 16) < a]
        lo, hi = max(loops, key=lambda span: sum(
            span[0] <= a <= span[1] and o == "MUFU.EX2" for a, o, _ in ins))
        ops = Counter(o.split(".")[0] for a, o, _ in ins if lo <= a <= hi)
        print(f"SASS WP {name.group(1)} groups {name.group(2)} blocks an SM "
              f"{name.group(3)}: main loop {sum(ops.values())} instructions; "
              + ", ".join(f"{o} {c}" for o, c in ops.most_common(14)),
              flush=True)


def child(lib_path, name):
    import torch

    from chip_smoke import cuda_ms
    from efficient_slowfast_tpu_torch.ops.kernels import _build
    from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as fa

    lib = ctypes.CDLL(lib_path)
    _build._loaded["flash_attention_bwd"] = lib
    gen = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
    total = 0.0
    for b, n, d in SHAPES:
        q, k, v, g = rn(b, n, d), rn(b, n, d), rn(b, n, d), rn(b, n, d)
        out, lse = fa._forward(q, k, v, True)
        if name == "stamps":
            h = (ctypes.c_ulonglong * 32)()
            fa.flash_attention_backward(q, k, v, out, lse, g)
            torch.cuda.synchronize()
            lib.probe_read(h)  # reset after the warm-up call
            fa.flash_attention_backward(q, k, v, out, lse, g)
            torch.cuda.synchronize()
            lib.probe_read(h)
            for wg in range(2):
                tiles = h[8 * wg + 7]
                if tiles:
                    print(f"stamps N {n} D {d} warpgroup {wg}: cycles per "
                          "tile: " + ", ".join(
                              f"{st} {h[8 * wg + i] / tiles:.0f}"
                              for i, st in enumerate(STAGES)), flush=True)
        ms = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, g),
                     iters=3, reps=3)
        total += ms
        print(f"{name} N {n} D {d}: {ms:.4f} ms", flush=True)
    print(f"{name} per train step: {total:.4f} ms", flush=True)


def main(names):
    from efficient_slowfast_tpu_torch.ops.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    texts = variants(open(SRC).read())
    names = names or list(texts)
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.copytree(_build.CSRC, d)
        with open(os.path.join(d, "flash_attention_bwd.cu"), "w") as f:
            f.write(texts[name])
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(["flash_attention"])  # the forward gives out and lse
    for name, proc in list(procs.items()):
        report = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed, skipped\n{report[-3000:]}", flush=True)
            del procs[name]
    if "kernel" in procs:
        sass_census(os.path.join(OUT, "kernel", "lib.so"))
    order = ["kernel"] + [n for n in names if n != "kernel"] + ["kernel"]
    for name in order:
        if name not in procs:
            continue
        try:
            subprocess.run([sys.executable, __file__, "--child",
                            os.path.join(OUT, name, "lib.so"), name],
                           timeout=300, check=True)
        except (subprocess.TimeoutExpired, subprocess.CalledProcessError) as e:
            print(f"{name}: no result ({e})", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1:])
