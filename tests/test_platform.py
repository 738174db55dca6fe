"""What the program decides from the platform it runs on: the numerical
policy table, the compile-cache location, the refusal to time a CPU, the
coordinator port, and that device failures are never hidden."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform,accumulate,qr_method", [
    ("cpu", "strict", "householder"),
    ("gpu", "fast", "mixed"),
])
def test_backend_policy(platform, accumulate, qr_method):
    from qgs_jax.utils.backend import backend_policy

    pol = backend_policy(platform)
    assert (pol.accumulate, pol.qr_method) == (accumulate, qr_method)


def test_backend_policy_defaults_to_running_platform():
    from qgs_jax.ops.twofloat import _resolve_accumulate
    from qgs_jax.utils.backend import backend_policy

    assert backend_policy() == backend_policy("cpu")
    assert _resolve_accumulate("auto") == "strict"
    assert _resolve_accumulate("fast") == "fast"


@pytest.mark.parametrize("platform", ["rocm", "metal", "cuda"])
def test_backend_policy_refuses_unknown_platform(platform):
    from qgs_jax.utils.backend import backend_policy

    with pytest.raises(ValueError, match="no numerical policy"):
        backend_policy(platform)


def _cache_dir_in_subprocess(tmp_path, env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", HOME=str(tmp_path))
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from qgs_jax.utils.compile_cache import "
            "enable_compile_cache; d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    target = str(tmp_path / "cache")
    returned, configured = _cache_dir_in_subprocess(tmp_path, target)
    assert returned == configured == target


def test_compile_cache_defaults_to_repo(tmp_path):
    returned, configured = _cache_dir_in_subprocess(tmp_path, None)
    assert returned == configured == str(REPO / ".jax_cache")


def test_bench_refuses_cpu():
    sys.path.insert(0, str(REPO))
    import bench

    with pytest.raises(SystemExit, match="GPU only"):
        bench.device_description()


def test_free_port_is_bindable():
    from qgs_jax.parallel.distributed import free_port

    port = free_port()
    assert 0 < port < 65536
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", port))


def test_clv_subspace_propagates_device_errors(monkeypatch):
    """A failure of the on-device intersection reaches the caller: there is
    no host fallback."""
    from qgs_jax.models.tendencies import create_tendencies
    from qgs_jax.params.params import QgParams
    from qgs_jax.toolbox import lyapunov

    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    f, Df = create_tendencies(pars)

    def broken(Bfull, Ffull):
        raise RuntimeError("device failure")

    monkeypatch.setattr(lyapunov, "_subspace_intersect", broken)
    ic = np.full((1, pars.ndim), 0.01)
    with pytest.raises(RuntimeError, match="device failure"):
        lyapunov.compute_clvs_subspace(f.batched, Df.batched, 0., 0.2, 0.4,
                                       0.6, 0.1, 0.1, ic)
