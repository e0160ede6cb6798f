from torch_replay import replay
replay("test_lockdep.py", globals(), subs=[
    ('"! tensor_sink name=sink")', '"! tensor_sink name=sink", device="cpu")'),
])


# -- the port alone: one package's witness, the other's locks untouched -----

import json as _json  # noqa: E402


def test_port_witness_leaves_the_jax_packages_locks_unwrapped(tmp_path):
    """Armed in a subprocess, the port's witness wraps the port's locks
    and not the JAX package's (its directory name is a prefix of the
    port's), and disable() restores the constructors."""
    script = tmp_path / "both.py"
    script.write_text(
        "import json, threading\n"
        "from nnstreamer_tpu_torch.utils import lockdep\n"
        "import nnstreamer_tpu.runtime.batching as jb\n"
        "import nnstreamer_tpu_torch.runtime.batching as tb\n"
        "lockdep.enable()\n"
        "t = tb.MicroBatcher(4, 0.01, lambda items: None, name='t')\n"
        "j = jb.MicroBatcher(4, 0.01, lambda items: None, name='j')\n"
        "out = {'port': type(t._flush_serial_lock).__name__,\n"
        "       'jax': type(j._flush_serial_lock).__name__,\n"
        "       'port_dispatch_ok': t._flush_serial_lock._dok}\n"
        "lockdep.disable()\n"
        "out['restored'] = type(threading.Lock()).__name__\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNS_TPU_")}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    cp = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, text=True, timeout=120)
    assert cp.returncode == 0, cp.stderr
    out = _json.loads(cp.stdout.strip().splitlines()[-1])
    assert out["port"] == "_LockProxy"
    assert out["jax"] == "lock"
    assert out["port_dispatch_ok"] is True
    assert out["restored"] == "lock"


def test_jax_lockdep_key_leaves_the_port_unarmed(tmp_path):
    """NNS_TPU_LOCKDEP arms the JAX package's witness only: the port
    reads NNS_TPU_TORCH_LOCKDEP."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNS_TPU_")}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
                "NNS_TPU_LOCKDEP": "1", "NNS_TPU_LOCKDEP_SCOPE": "all"})
    cp = subprocess.run([sys.executable, "-c", (
        "import threading\n"
        "import nnstreamer_tpu_torch\n"
        "from nnstreamer_tpu_torch.utils import lockdep\n"
        "print(lockdep.enabled(), type(threading.Lock()).__name__)\n")],
        env=env, capture_output=True, text=True, timeout=120)
    assert cp.returncode == 0, cp.stderr
    assert cp.stdout.split() == ["False", "lock"]


def test_committed_port_baseline_is_valid_json():
    """The port's baseline (the diff CLI's default) parses, allows no
    cycle, and names only the port's own lock sites."""
    path = os.path.join(REPO, "tests", "lockdep_torch_baseline.json")
    with open(path) as f:
        base = _json.load(f)
    assert base["version"] == 1 and base["allowed_cycles"] == []
    assert base["edges"] and all(
        a.startswith("nnstreamer_tpu_torch/")
        and b.startswith("nnstreamer_tpu_torch/") for a, b in base["edges"])
