"""Optional real-MatterSim binding.

Drops the Matterport3DSimulator C++ module behind the GraphSimulator surface
used by EnvBatch (the reference instantiates it rendering-disabled,
map_nav_src/r2r/env.py:48-61 — a pure navigation-graph state
machine, which is why the in-repo pure-python GraphSimulator is exactly
equivalent at train time). Import requires the external `MatterSim` pybind
module and scan connectivity data on disk.
"""

from __future__ import annotations

from typing import Dict

from .env import SimState


class MatterSimSimulator:
    """Same surface as nav.env.GraphSimulator, backed by MatterSim."""

    def __init__(self, connectivity_dir: str, scan_data_dir: str = ""):
        import MatterSim  # external C++ pybind module

        sim = MatterSim.Simulator()
        sim.setNavGraphPath(connectivity_dir)
        if scan_data_dir:
            sim.setDatasetPath(scan_data_dir)
        sim.setRenderingEnabled(False)
        sim.setDiscretizedViewingAngles(True)
        sim.setCameraResolution(640, 480)
        sim.setCameraVFOV(1.0471975511965976)  # 60 degrees, ref env.py
        sim.setBatchSize(1)
        sim.initialize()
        self.sim = sim
        self.state = SimState()

    def new_episode(self, scan: str, viewpoint: str, heading: float,
                    elevation: float = 0.0):
        self.sim.newEpisode([scan], [viewpoint], [heading], [elevation])
        self._sync()

    def _sync(self):
        s = self.sim.getState()[0]
        self.state = SimState(
            scan=s.scanId,
            viewpoint=s.location.viewpointId,
            heading=s.heading,
            elevation=s.elevation,
        )

    def get_state(self) -> SimState:
        return self.state

    def navigable_locations(self):
        """Raw MatterSim navigableLocations (used only if a caller wants the
        sim's own candidate geometry instead of the connectivity graphs)."""
        return self.sim.getState()[0].navigableLocations
