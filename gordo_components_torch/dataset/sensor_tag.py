"""Sensor tags (counterpart of ``gordo_components_tpu/dataset/sensor_tag.py``):
configurations name tags as bare strings, ``[name, asset]`` pairs or
``{name:, asset:}`` dicts; normalization canonicalizes them."""

from typing import List, NamedTuple, Optional, Union


class SensorTag(NamedTuple):
    name: str
    asset: Optional[str] = None


TagSpec = Union[str, dict, list, tuple, SensorTag]


def normalize_sensor_tag(tag: TagSpec, asset: Optional[str] = None) -> SensorTag:
    if isinstance(tag, SensorTag):
        return tag
    if isinstance(tag, str):
        return SensorTag(name=tag, asset=asset)
    if isinstance(tag, dict):
        return SensorTag(name=tag["name"], asset=tag.get("asset", asset))
    if isinstance(tag, (list, tuple)) and 1 <= len(tag) <= 2:
        return SensorTag(name=tag[0], asset=tag[1] if len(tag) == 2 else asset)
    raise ValueError(f"Cannot normalize sensor tag from {tag!r}")


def normalize_sensor_tags(tags: List[TagSpec], asset: Optional[str] = None) -> List[SensorTag]:
    return [normalize_sensor_tag(t, asset) for t in tags]
