"""A configuration at a CPU test's size: its family's cut (``small``),
which cuts every width and keeps the kinds of layer, their order and the
options."""

from portbench import catalog


def reduced(config: dict, dtype: str = "float32") -> dict:
    return catalog.family(config["family"]).small(dict(config, param_dtype=dtype))
