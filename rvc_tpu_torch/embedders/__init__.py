from .hubert import Hubert, HubertConfig

__all__ = ["Hubert", "HubertConfig"]
