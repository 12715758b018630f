"""PyTorch port: every public name of the JAX package's modules exists in
the port's counterpart, with the documented renames; nothing is left to
port."""

import __future__
import importlib
import inspect
import types

import pytest

MODULES = ["", ".container.riff", ".container.demux", ".container.mux",
           ".container.anim", ".utils.metrics", ".utils.bittrace",
           ".decode_options", ".config", ".errors", ".stats", ".picture",
           ".idec"]

# reference name -> the port's name for it
RENAMED = {
    ".container.riff": {"_vp8_dimensions": "vp8_dimensions",
                        "_vp8l_dimensions": "vp8l_dimensions"},
}
# parameters: the reference's use_tpu flag is the port's device; the port
# adds device (None means CUDA) and the batch decode's stage timings
RENAMED_PARAMS = {"use_tpu": "device"}
ADDED_PARAMS = {"device", "timings"}


def _public(mod):
    """The module's __all__, or its public top-level names that it
    defines itself (no imported modules, functions or classes)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {k for k, v in vars(mod).items()
            if not k.startswith("_")
            and not isinstance(v, (types.ModuleType, __future__._Feature))
            and not (callable(v) and getattr(v, "__module__", mod.__name__)
                     != mod.__name__)}


def _pair(name):
    return (importlib.import_module("gowebp_tpu" + name),
            importlib.import_module("gowebp_tpu_torch" + name))


@pytest.mark.parametrize("name", MODULES)
def test_every_public_name_is_ported(name):
    ref, port = _pair(name)
    names = _public(ref)
    assert names
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"gowebp_tpu{name}: {missing} not in the port"
    for old, new in RENAMED.get(name, {}).items():
        assert hasattr(ref, old) and hasattr(port, new)


@pytest.mark.parametrize("name", MODULES)
def test_public_callables_take_the_reference_parameters(name):
    """Each public function and class takes the reference's parameters
    (``use_tpu`` as ``device``), and adds at most ``device`` and
    ``timings``."""
    ref, port = _pair(name)
    for n in sorted(_public(ref)):
        a, b = getattr(ref, n), getattr(port, n)
        if not callable(a) or isinstance(a, type) and issubclass(
                a, BaseException):
            continue
        want = [RENAMED_PARAMS.get(k, k)
                for k in inspect.signature(a).parameters]
        got = list(inspect.signature(b).parameters)
        assert [k for k in want if k not in got] == [], n
        assert set(got) - set(want) <= ADDED_PARAMS, n


def test_package_all_is_the_reference_all():
    ref, port = _pair("")
    assert set(ref.__all__) <= set(port.__all__)
