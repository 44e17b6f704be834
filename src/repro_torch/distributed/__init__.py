"""Logical-axis sharding rules over a torch `DeviceMesh` (`sharding.py`:
specs, DTensor placements, constraints as redistributions) and the ring
all-gather matmul (`collective_matmul.py`); the meshes come from
`launch.mesh`."""
