"""Control-plane metadata digest.

Counterpart of ``gordo_components_tpu/utils/digest.py`` (the port keeps its
own copy): the few fields of a model's endpoint metadata that a fleet
dashboard keys on, served per target by ``metadata-all?digest=1`` so a
watchman's periodic poll costs small bytes, with the full metadata still
served without the flag and per target.
"""

from typing import Any, Dict

__all__ = ["metadata_digest"]


def metadata_digest(md: Dict[str, Any]) -> Dict[str, Any]:
    """Flat, bounded-size summary of one artifact's endpoint metadata.

    Every field degrades to absent rather than raising on foreign or
    partial metadata."""
    md = md if isinstance(md, dict) else {}
    model = md.get("model") or {}
    if not isinstance(model, dict):
        model = {}
    cfg = model.get("model_config")
    dataset = md.get("dataset") or {}
    tags = dataset.get("tag_list") if isinstance(dataset, dict) else None
    digest: Dict[str, Any] = {
        "name": md.get("name"),
        "checked_at": md.get("checked_at"),
        # the dotted path of the config's root names the model family
        "model": next(iter(cfg), None) if isinstance(cfg, dict) else None,
        "cache_key": model.get("model_builder_cache_key"),
        "n_tags": len(tags) if isinstance(tags, (list, tuple)) else None,
        "trained": model.get("trained"),
    }
    # absent fields are dropped, not spelled out as nulls
    digest = {k: v for k, v in digest.items() if v is not None}
    if model.get("fleet_trained"):
        digest["fleet_trained"] = True
    cv = model.get("cross-validation")
    if isinstance(cv, dict):
        ev = cv.get("explained-variance")
        if isinstance(ev, dict) and "mean" in ev:
            digest["cv_mean_explained_variance"] = ev["mean"]
    return digest
