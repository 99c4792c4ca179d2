"""``--computeDtype`` in the port's CLIs against the JAX package's: the
CLIs whose JAX counterparts take it take it with the same default
(``train_brdf`` and ``train_light`` bfloat16, ``test_real`` float32), and
the others take no such option, as theirs do not.  Parsing only; a step
of each training CLI in either dtype is in tests/test_torch_cli.py."""

import importlib

import pytest

CLIS = ("train_brdf", "train_light", "test_real", "train_bilateral",
        "train_finetune_iiw", "train_finetune_nyu", "output_brdf_light",
        "test_synthetic", "build_cache")
WITH_DTYPE = {"train_brdf": "bfloat16", "train_light": "bfloat16",
              "test_real": "float32"}


def parsers(name):
    return [importlib.import_module(f"{pkg}.cli.{name}").parse_args
            for pkg in ("inverserenderingofindoorscene_tpu",
                        "inverserenderingofindoorscene_torch")]


def argv(name):
    return (["--imList", "x.txt", "--output", "out"] if name == "test_real"
            else [])


@pytest.mark.parametrize("name", CLIS)
def test_default_compute_dtype_matches_jax(name):
    jax_opt, port_opt = (parse(argv(name)) for parse in parsers(name))
    assert (getattr(port_opt, "computeDtype", None)
            == getattr(jax_opt, "computeDtype", None)
            == WITH_DTYPE.get(name))


@pytest.mark.parametrize("name", CLIS)
def test_compute_dtype_accepted_where_jax_accepts_it(name):
    for dtype in ("float32", "bfloat16"):
        args = argv(name) + ["--computeDtype", dtype]
        if name in WITH_DTYPE:
            assert all(parse(args).computeDtype == dtype
                       for parse in parsers(name))
        else:
            for parse in parsers(name):
                with pytest.raises(SystemExit):
                    parse(args)
