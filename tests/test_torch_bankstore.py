"""The port's native bank store (``gennet_tpu_torch.data.bankstore``)
against the JAX package's: the same C source and ABI, so a ``.gntb`` that
either package writes is read by the other, bit for bit, with its checksum
verified. The port builds its own copy of the library from
``native/bankstore.cpp`` into ``build/gennet_tpu_torch/``.
"""

import numpy as np
import pytest

from gennet_tpu.data import bankstore as jbs
from gennet_tpu_torch.data import bankstore as tbs


@pytest.fixture(scope="module")
def bank_data():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(300, 128)).astype(np.float32)
    p = {k: rng.uniform(0.5, 35, 300).astype(np.float32) for k in tbs.PARAM_ORDER}
    return t, p


@pytest.mark.parametrize("writer,reader", [(tbs, jbs), (jbs, tbs), (tbs, tbs)])
def test_banks_read_across_packages(tmp_path, bank_data, writer, reader):
    t, p = bank_data
    path = str(tmp_path / "bank.gntb")
    writer.write_bank(path, t, p)
    with reader.BankStore(path, verify=True) as store:
        assert (store.n, store.n_pix, store.n_par) == (300, 128, len(tbs.PARAM_ORDER))
        np.testing.assert_array_equal(store.templates, t)
        for j, k in enumerate(tbs.PARAM_ORDER):  # columns in PARAM_ORDER
            np.testing.assert_array_equal(store.params[:, j], p[k])


def test_identical_files_from_both_packages(tmp_path, bank_data):
    t, p = bank_data
    for pkg, name in ((jbs, "j.gntb"), (tbs, "t.gntb")):
        pkg.write_bank(str(tmp_path / name), t, {"mc": p["mc"], "q": p["q"]})
    assert (tmp_path / "j.gntb").read_bytes() == (tmp_path / "t.gntb").read_bytes()


def test_gather_matches_numpy_and_the_reference(tmp_path, bank_data):
    t, p = bank_data
    path = str(tmp_path / "bank.gntb")
    tbs.write_bank(path, t, p)
    idx = np.random.default_rng(1).integers(0, 300, 64)
    with tbs.BankStore(path) as store, jbs.BankStore(path) as ref:
        gt, gp = store.gather(idx)
        rt, rp = ref.gather(idx)
        np.testing.assert_array_equal(gt, t[idx])
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gp, rp)
        with pytest.raises(IndexError):
            store.gather(np.asarray([1_000_000]))


def test_corruption_detected(tmp_path, bank_data):
    t, p = bank_data
    path = str(tmp_path / "bank.gntb")
    tbs.write_bank(path, t, p)
    raw = bytearray(open(path, "rb").read())
    raw[64 + 1000] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(OSError):
        tbs.BankStore(path, verify=True)
    tbs.BankStore(path, verify=False).close()  # the unverified open still maps it
    with pytest.raises(OSError):
        tbs.BankStore(str(tmp_path / "missing.gntb"))


def test_bad_shapes_are_refused(tmp_path):
    with pytest.raises(ValueError, match="templates"):
        tbs.write_bank(str(tmp_path / "b.gntb"), np.zeros(8, np.float32), {})
    with pytest.raises(ValueError, match="params"):
        tbs.write_bank(str(tmp_path / "b.gntb"), np.zeros((8, 4), np.float32),
                       np.zeros((7, 2), np.float32))


def test_library_is_built_from_the_native_source():
    tbs._load()
    built = sorted(tbs.BUILD_DIR.glob("libbankstore_*.so"))
    assert built and tbs.SOURCE.name == "bankstore.cpp" and tbs.SOURCE.parent.name == "native"
    assert tbs.BUILD_DIR.parts[-2:] == ("build", "gennet_tpu_torch")
