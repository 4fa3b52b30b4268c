from .hubert import (EMBEDDER_REGISTRY, Hubert, HubertConfig, load_embedder,
                     load_embedder_by_name, resolve_embedder_path)

__all__ = ["EMBEDDER_REGISTRY", "Hubert", "HubertConfig", "load_embedder",
           "load_embedder_by_name", "resolve_embedder_path"]
