"""Host seconds of the set-up's outermost ``model.build`` spans: the
program's model construction (``models/registry.get_model``)."""


def read(t):
    return t.get("spans", {}).get("model_build_s")
