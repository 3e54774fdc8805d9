"""A cell cut to a size the CPU runs in seconds: 32x32 frames, a 64^3
volume at 8 cm over the same room, a 16-pose orbit, chunks of 4. Widths
(nets, samples, classes) stay as the cell's configuration states them."""

import copy

from gpubench import harness


def tiny_cell(name: str, limits=None) -> harness.Cell:
    cell = harness.load_cell(name)
    conf = copy.deepcopy(cell.config)
    conf["config"]["DATA"].update(resx=32, resy=32)
    conf["config"]["TESTING"]["sequence_chunk"] = 4
    conf["assumed"].update(volume_shape=[64, 64, 64], voxel_size=0.08,
                           volume_origin=[-2.56] * 3)
    traffic = dict(cell.traffic, orbit_poses=16, profile_units=2)
    if traffic["loop"] == "live":
        traffic["rate_fps"] = 50.0
    return harness.Cell(cell.entry, cell.bench, conf, traffic,
                        cell.limits if limits is None else limits)
