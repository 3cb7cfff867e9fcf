"""What a run loads: nothing of JAX or the JAX package, compared by whole
top-level names, and a reference that loads nothing of the program."""

import json
import os
import subprocess
import sys

from port_bench import manifest

FORBIDDEN = ["jax", "jaxlib", "flax", "efficient_slowfast_tpu"]


def _modules(code):
    probe = (f"import sys; sys.path.insert(0, {manifest.ROOT!r}); {code}; "
             "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_and_the_harness_load_no_jax():
    mods = _modules(
        "import importlib.util as u; s = u.spec_from_file_location('r', "
        f"{os.path.join(manifest.HERE, 'run.py')!r}); m = "
        "u.module_from_spec(s); s.loader.exec_module(m); "
        "import port_bench.calibrate, port_bench.serving, port_bench.trace; "
        "from port_bench import manifest as b; "
        "[b.driver_class(k) for k in ('serve_batch', 'request', "
        "'train_step')]; import efficient_slowfast_tpu_torch.engine.state, "
        "efficient_slowfast_tpu_torch.engine.inference")
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert "efficient_slowfast_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _modules("import port_bench.reference.model, "
                    "port_bench.reference.attention, port_bench.compare, "
                    "port_bench.formulas, port_bench.recipe")
    bad = FORBIDDEN + ["efficient_slowfast_tpu_torch"]
    assert not [m for m in mods if m.split(".")[0] in bad]


def test_forbidden_names_are_whole_top_level_names():
    spec = __import__("importlib.util").util.spec_from_file_location(
        "port_bench_run", os.path.join(manifest.HERE, "run.py"))
    run = __import__("importlib.util").util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert "efficient_slowfast_tpu" in run.FORBIDDEN
    saved = sys.modules.get("efficient_slowfast_tpu_torch_x")
    sys.modules["efficient_slowfast_tpu_torch_x"] = sys
    try:
        assert "efficient_slowfast_tpu_torch_x" not in run.forbidden_modules()
    finally:
        if saved is None:
            del sys.modules["efficient_slowfast_tpu_torch_x"]
