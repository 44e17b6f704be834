"""Logical-axis sharding rules (`sharding.py`). The mesh half — a torch
`DeviceMesh` behind the rules, DTensor placements, `collective_matmul` —
is not ported yet (ROADMAP Queue A item 1)."""
