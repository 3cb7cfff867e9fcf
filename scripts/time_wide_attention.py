"""Times K2 and K2-bwd (bf16) at the wide shapes of chip_smoke.py's phase
21 and beside them, on one NVIDIA GPU, through the public wrappers of the
checkout it runs from:

    python3 scripts/time_wide_attention.py LABEL [--variants]

Per shape it prints the CUDA-event ms a call (median of 5 rounds of 10
calls, 3 of 2 at the 16-clip D = C = 3072 row), the host's enqueue us a
call, the device time of a call's kernels from torch.profiler (CUDA
activity), and scaled_dot_product_attention's event ms, with the card's
name and power limit; LABEL starts each line. To compare two commits in
one call, run it from each checkout in turns (parent, change, change,
parent). With --variants, the forward at D above 2048 also runs three
other plans of its streamed cluster (pushers, slices a pusher, rounds of
the exchange), each checked against the plain version first."""
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, ".")
from efficient_slowfast_tpu_torch.ops.kernels import _build  # noqa: E402
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

label = sys.argv[1]
_build.build(["flash_attention", "flash_attention_bwd"])
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
FWD = [(1, 777, 190, 3072, 3072), (1, 777, 190, 300, 2100),
       (16, 1568, 392, 3072, 3072), (1, 777, 190, 256, 16448),
       (1, 777, 190, 600, 700), (2, 1000, 250, 64, 2048),
       (2, 1000, 250, 2048, 64), (16, 1568, 392, 1024, 1024),
       (8, 3136, 784, 256, 256)]
BWD = [(1, 777, 190, 3072, 3072), (1, 777, 190, 300, 2100),
       (16, 1568, 392, 3072, 3072), (2, 777, 190, 600, 700),
       (2, 1000, 250, 64, 2048), (2, 1000, 250, 2048, 64),
       (16, 1568, 392, 1024, 1024), (8, 3136, 784, 256, 256)]
gen = torch.Generator(device="cuda").manual_seed(3)


def inputs(b, n, m, d, c):
    f = (3.0 / d ** 0.5) ** 0.5
    return [torch.randn(b, x, w, generator=gen, device="cuda").mul(s)
            .bfloat16() for x, w, s in ((n, d, f), (m, d, f), (m, c, 1.0),
                                        (n, c, 1.0))]


def event_ms(fn, iters=10, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def host_us(fn, iters=20):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / iters * 1e6


def device_ms(fn, calls=5):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if t is None else t
    return total / calls / 1e3


def row(kind, shape, fn, lib=None, extra=""):
    try:
        _row(kind, shape, fn, lib, extra)
    except Exception as e:  # the parent's planner raises at (256, 16448)
        print(f"{label} {kind} {shape}: raised {e!r}", flush=True)


def _row(kind, shape, fn, lib=None, extra=""):
    big = shape[0] * shape[1] * shape[2] > 2 ** 22 and max(shape[3:]) > 2048
    reps = dict(iters=2, reps=3) if big else {}
    ms = event_ms(fn, **reps)
    line = (f"{label} {kind} {shape}: event {ms:.4f} ms | host "
            f"{host_us(fn, 5 if big else 20):.1f} us | device "
            f"{device_ms(fn, 2 if big else 5):.4f} ms")
    if lib is not None:
        line += f" | sdpa {event_ms(lib, **reps):.4f} ms"
    print(line + extra + f" | {smi}", flush=True)


for shape in FWD:
    q, k, v, _ = inputs(*shape)
    row("fwd", shape, lambda: fa.flash_attention(q, k, v),
        lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], scale=1.0))
    if "--variants" in sys.argv and max(shape[3:]) > 2048 and shape[3] > 2048:
        base = fa.forward_split
        for pushers, slices, rounds in ((2, 6, 1), (3, 4, 2), (4, 3, 2)):
            def variant(*a, pushers=pushers, slices=slices, rounds=rounds):
                plan = dict(base(*a), pushers=pushers, slices=slices,
                            rounds=rounds)
                plan["smem"] = fa.cluster_smem_bytes(
                    2, plan["width"], plan["keys"], 2, 2, pushers, rounds)
                return plan
            fa.forward_split = variant
            out = fa.flash_attention(q, k, v)
            err = (out.float() - fa.chunked_attention(q, k, v).float()).abs(
                ).max().item()
            row("fwd", shape, lambda: fa.flash_attention(q, k, v),
                extra=f" | variant P {pushers} slices {slices} rounds "
                f"{rounds}, err {err:.3e}")
            fa.forward_split = base
    del q, k, v
    torch.cuda.empty_cache()

for shape in BWD:
    q, k, v, g = inputs(*shape)
    out, lse = fa._forward(q, k, v, with_lse=True)
    q4, k4, v4 = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    row("bwd", shape, lambda: fa.flash_attention_backward(
        q, k, v, out, lse, g), lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g[:, None], retain_graph=True))
    del q, k, v, g, out, lse, q4, k4, v4, o4
    torch.cuda.empty_cache()
