"""LLMTailor core of the port: manifests, policies, the layer registry, and
the YAML-driven explicit merge (``recipe`` + ``tailor``)."""
from repro_torch.core.recipe import (  # noqa: F401
    CheckpointRef, Recipe, SelectRule)


def __getattr__(name):
    # ``merge`` is imported on first use: ``tailor`` is also the merge CLI
    # (``python -m repro_torch.core.tailor``), which runpy must find
    # unimported, and it imports the restore engine, which imports this
    # package.
    if name == "merge":
        from repro_torch.core.tailor import merge
        return merge
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
