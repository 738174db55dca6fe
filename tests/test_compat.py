"""Drop-in ``qgs`` namespace compatibility (qgs_jax/compat.py).

Reference users import from the ``qgs.*`` module tree (ref
``qgs/functions/tendencies.py``, ``qgs/params/params.py``); after
``import qgs_jax.compat`` those exact import paths must resolve to the
qgs_jax implementations.
"""

import numpy as np


def test_reference_import_paths_resolve():
    import qgs_jax.compat  # noqa: F401 — installs the alias finder

    from qgs.params.params import QgParams
    from qgs.functions.tendencies import create_tendencies
    from qgs.integrators.integrator import RungeKuttaIntegrator  # noqa: F401
    from qgs.tensors.qgtensor import QgsTensor  # noqa: F401
    from qgs.tensors.atmo_thermo_tensor import AtmoThermoTensor  # noqa: F401
    from qgs.functions.sparse_mul import sparse_mul2, sparse_mul3  # noqa: F401
    from qgs.toolbox.lyapunov import LyapunovsEstimator  # noqa: F401
    import qgs.basis.fourier  # noqa: F401
    import qgs.inner_products.analytic  # noqa: F401
    import qgs.plotting.util  # noqa: F401

    import qgs_jax.params.params as real_params
    import qgs.params.params as alias_params
    assert alias_params is real_params

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    f, Df = create_tendencies(pars)
    x = np.random.default_rng(1).random(pars.ndim) * 0.01

    from qgs_jax.models.tendencies import create_tendencies as real_create
    f2, _ = real_create(pars)
    np.testing.assert_allclose(np.asarray(f(0., x)), np.asarray(f2(0., x)),
                               rtol=0, atol=0)


def test_entry_script_style_imports():
    """The reference entry scripts' import block (ref ``qgs_rp.py:23-30``)."""
    import qgs_jax.compat  # noqa: F401

    from qgs.params.params import QgParams  # noqa: F401
    from qgs.integrators.integrator import RungeKuttaIntegrator  # noqa: F401
    from qgs.functions.tendencies import create_tendencies  # noqa: F401
