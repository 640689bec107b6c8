"""nuScenes category helpers: a host copy of `monoloco_tpu/utils/nuscenes.py`."""


def select_categories(cat):
    """Map a coarse category name to nuScenes category prefixes."""
    assert cat in ('person', 'all', 'car', 'cyclist')
    if cat == 'person':
        return ['human.pedestrian']
    if cat == 'all':
        return ['human.pedestrian', 'vehicle.bicycle', 'vehicle.motorcycle']
    if cat == 'cyclist':
        return ['vehicle.bicycle']
    return ['vehicle.car']
