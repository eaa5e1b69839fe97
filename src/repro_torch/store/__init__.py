"""Tiered feature storage for the port: the host table (pinned on the
card), the device hot-row cache, and the planless tiered row source of
the sampled path.  The plan-bound chunk assembly waits for the
tiered-serving slice."""
from .feature_store import FeatureStore
from .hotfeatures import HotFeatureCache
from .tiered import TieredFeatures

__all__ = ["FeatureStore", "HotFeatureCache", "TieredFeatures"]
