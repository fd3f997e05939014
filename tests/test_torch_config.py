"""The port's INI settings against the JAX package's (``config.py``), on
the cases of ``tests/test_config.py``: the defaults, a user INI overlay,
the safe_data slash rule, the explicit safe_data argument, inline
comments, and a failed check restoring the default. Every comparison is
exact (the settings are strings and numbers)."""

import dataclasses

import pytest

from safepy_tpu import SAFE as JaxSAFE
from safepy_tpu import config as jax_config
from safepy_tpu_torch import SAFE
from safepy_tpu_torch import config as port_config

OVERLAY = """[Input files]
safe_data = /data/safe/
networkfile = networks/my_net.txt
annotationfile = attributes/my_attrs.txt
layoutAlgorithm = spring_tpu
annotationsign = highest   # OPTIONS: highest, lowest, both
[Analysis parameters]
nodeDistanceType = euclidean
neighborhoodRadius = 0.25
randomSeed = 123
unimodalityType = connectivity
groupDistanceThreshold = 0.5
"""


def _both(path="", safe_data=None):
    (pc, pd_), (jc, jd) = (port_config.read_config(path, safe_data),
                           jax_config.read_config(path, safe_data))
    return dataclasses.asdict(pc), dict(pd_), dataclasses.asdict(jc), dict(jd)


def _same_but_output_dir(port, jax):
    """The package directory is each package's own when no INI is given."""
    assert {k: v for k, v in port.items() if k != "output_dir"} == \
        {k: v for k, v in jax.items() if k != "output_dir"}


@pytest.mark.parametrize("case", ["defaults", "overlay", "safe_data_arg",
                                  "empty_ini"])
def test_read_config_matches_jax(case, tmp_path):
    path, safe_data = "", None
    if case == "overlay":
        path = tmp_path / "custom.ini"
        path.write_text(OVERLAY)
    elif case == "empty_ini":
        path = tmp_path / "empty.ini"
        path.write_text("")
    elif case == "safe_data_arg":
        safe_data = "/custom/root/"
    port, port_defaults, jax, jax_defaults = _both(str(path) if path else "",
                                                   safe_data)
    assert port_defaults == jax_defaults
    if path:
        assert port == jax
        assert port["output_dir"] == str(tmp_path)
    else:
        _same_but_output_dir(port, jax)
    if case == "overlay":
        assert port["path_to_network_file"] == "/data/safe/networks/my_net.txt"
        assert port["attribute_sign"] == "highest"  # inline comment stripped
        assert port["layout_algorithm"] == "spring_tpu"
        assert port["random_seed"] == 123


def test_safe_data_requires_trailing_slash(tmp_path):
    ini = tmp_path / "bad.ini"
    ini.write_text("[Input files]\nsafe_data = /data/safe\n")
    for read in (port_config.read_config, jax_config.read_config):
        with pytest.raises(AssertionError):
            read(str(ini))
    with pytest.raises(AssertionError):
        SAFE(path_to_ini_file=str(ini), device="cpu", verbose=False)


def test_facade_reads_the_ini_as_jax_does(tmp_path):
    ini = tmp_path / "custom.ini"
    ini.write_text(OVERLAY)
    psf = SAFE(str(ini), verbose=False, device="cpu")
    jsf = JaxSAFE(str(ini), verbose=False)
    for name in ("path_to_safe_data", "path_to_network_file",
                 "path_to_attribute_file", "attribute_sign", "background",
                 "layout_algorithm", "node_distance_metric",
                 "neighborhood_radius_type", "neighborhood_radius",
                 "random_seed", "attribute_unimodality_metric",
                 "attribute_distance_metric", "attribute_distance_threshold",
                 "output_dir", "num_permutations", "enrichment_threshold",
                 "enrichment_max_log10", "attribute_enrichment_min_size"):
        assert getattr(psf, name) == getattr(jsf, name), name
    assert dict(psf.default_config) == dict(jsf.default_config)


@pytest.mark.parametrize("attr,bad", [
    ("background", "nope"), ("node_distance_metric", "nope"),
    ("attribute_sign", "nope"), ("num_permutations", 3),
    ("enrichment_threshold", 1.5), ("enrichment_max_log10", "x"),
    ("attribute_enrichment_min_size", 1),
    ("attribute_distance_threshold", 2.0)])
def test_validation_restores_the_default_as_jax_does(attr, bad):
    psf, jsf = SAFE(device="cpu", verbose=False), JaxSAFE(verbose=False)
    for sf in (psf, jsf):
        setattr(sf, attr, bad)
        with pytest.raises(ValueError) as err:
            sf.validate_config()
        sf.message = str(err.value)
    assert psf.message == jsf.message
    got, want = getattr(psf, attr), getattr(jsf, attr)
    assert got == want and type(got) is type(want)
