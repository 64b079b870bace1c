"""CLI driver tests: bench and check modes end-to-end at tiny sizes."""

import os

import jax
import pytest

from svdsolver_tpu.cli import main
from svdsolver_tpu.utils.fixtures import REPO_DATA


def test_bench_base_writes_csv(tmp_path):
    out = tmp_path / "base.csv"
    rc = main(["bench", "base", "8", "3", "1", "--output", str(out)])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0].replace(" ", "") == "8,16"
    assert len(lines[1].split(",")) == 2


def test_bench_two_stage_writes_three_lines(tmp_path):
    out = tmp_path / "mc.csv"
    rc = main(["bench", "multicore", "16", "2", "1", "8", "--output", str(out)])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 3  # sizes / stage1 / stage2 (reference schema)


def test_bench_diagonal_qr(tmp_path):
    out = tmp_path / "diag.csv"
    rc = main(["bench", "diagonal", "16", "2", "1", "--diag", "qr",
               "--output", str(out)])
    assert rc == 0
    assert out.exists()


def test_bench_rejects_unknown_model():
    with pytest.raises(SystemExit):
        main(["bench", "nosuch", "8", "2", "1"])


def test_check_64():
    if not os.path.exists(os.path.join(REPO_DATA, "test_float_64_64.bin")):
        pytest.skip("fixtures not present")
    rc = main(["check", "64"])
    assert rc == 0


def test_fixture_roundtrip(tmp_path):
    import numpy as np
    from svdsolver_tpu.utils import fixtures as fx

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = tmp_path / "m.bin"
    fx.write_matrix(str(p), a)
    fx.write_matrix(str(p), a)  # truncating (unlike the reference's append)
    b = fx.read_matrix(str(p), 3, 4, np.float32)
    np.testing.assert_array_equal(a, b)


def test_svdvals_subcommand(tmp_path):
    import numpy as np
    from svdsolver_tpu.utils import fixtures as fx

    rng = np.random.default_rng(3)
    A = rng.normal(size=(16, 16)).astype(np.float32)
    p = tmp_path / "a.bin"
    fx.write_matrix(str(p), A)
    out = tmp_path / "s.bin"
    rc = main(["svdvals", str(p), "16", "--model", "base", "--output", str(out)])
    assert rc == 0
    s = np.fromfile(out, dtype=np.float32)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-4, atol=1e-5 * want[0])


def test_check_double_dtype():
    import numpy as np
    from svdsolver_tpu.utils.fixtures import REPO_DATA

    if not os.path.exists(os.path.join(REPO_DATA, "test_double_64_64.bin")):
        import pytest

        pytest.skip("fixtures not present")
    rc = main(["check", "64", "--dtype", "double"])
    assert rc == 0


def test_check_64_flagship_tpu2(capsys):
    # the correctness gate runs the flagship svdvals pipeline on whatever
    # backend is present — never a skip
    if not os.path.exists(os.path.join(REPO_DATA, "test_float_64_64.bin")):
        pytest.skip("fixtures not present")
    rc = main(["check", "64", "--model", "tpu2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "CHECK PASSED" in out and "SKIPPED" not in out
    assert f"on {jax.devices()[0].platform}" in out


def test_svd_subcommand(tmp_path):
    import numpy as np
    from svdsolver_tpu.utils import fixtures as fx

    rng = np.random.default_rng(4)
    n = 32
    A = rng.normal(size=(n, n)).astype(np.float32)
    p = tmp_path / "a.bin"
    fx.write_matrix(str(p), A)
    pre = str(tmp_path / "out")
    rc = main(["svd", str(p), str(n), "--output-prefix", pre])
    assert rc == 0
    U = np.fromfile(pre + "_U.bin", dtype=np.float32).reshape(n, n)
    s = np.fromfile(pre + "_s.bin", dtype=np.float32)
    Vh = np.fromfile(pre + "_Vh.bin", dtype=np.float32).reshape(n, n)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-4, atol=1e-5 * want[0])
    np.testing.assert_allclose(U @ np.diag(s) @ Vh, A, atol=5e-5 * want[0])
    # top-k variant
    rc = main(["svd", str(p), str(n), "-k", "4", "--output-prefix", pre])
    assert rc == 0
    s4 = np.fromfile(pre + "_s.bin", dtype=np.float32)
    assert s4.shape == (4,)
    np.testing.assert_allclose(s4, want[:4], rtol=2e-4, atol=1e-5 * want[0])


def test_generated_fixtures_native(tmp_path, rng):
    # fixtures for unshipped sizes come from the native C++ oracle and are
    # a genuine cross-implementation differential vs the JAX reduction
    import pytest
    import numpy as np
    import jax.numpy as jnp

    from svdsolver_tpu.utils import fixtures as fx

    try:
        from svdsolver_tpu.utils.native import get_lib

        get_lib()
    except Exception:
        pytest.skip("native library unavailable")
    n, band = 96, 4
    fx.ensure_generated_fixtures(n, band=band, data_dir=str(tmp_path))
    A0 = fx.load_fixture("test", n, data_dir=str(tmp_path))
    band_ref = fx.load_fixture("band", n, data_dir=str(tmp_path))
    from svdsolver_tpu.models.two_stage import dense_to_band

    Ab = np.asarray(dense_to_band(jnp.asarray(A0), band=band))
    assert fx.band_mse(Ab, band_ref, band) < 1e-3
    sig = np.linalg.svd(band_ref.astype(np.float64), compute_uv=False)
    ref = np.linalg.svd(A0.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(sig - ref)) / ref[0] < 1e-5
