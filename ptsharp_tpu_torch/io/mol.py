"""Chemical molfile (SDF V2000) parsing -> ball-and-stick scenes.

A copy of ptsharp_tpu/io/mol.py for the port's SceneBuilder. Parity with
the reference's molecule pipeline (Example.mol,
Example.cs:538-816): parse atoms + bonds, place CPK-colored spheres per atom
and transformed cylinders per bond (NewTransformedCylinder,
Cylinder.cs:21-35).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ptsharp_tpu_torch.materials import glossy_material

# CPK-ish element colors + covalent radii (Å scale)
ELEMENTS = {
    "H": (0.35, (0.95, 0.95, 0.95)),
    "C": (0.70, (0.20, 0.20, 0.20)),
    "N": (0.65, (0.19, 0.31, 0.97)),
    "O": (0.60, (1.00, 0.05, 0.05)),
    "F": (0.50, (0.56, 0.88, 0.31)),
    "P": (1.00, (1.00, 0.50, 0.00)),
    "S": (1.00, (1.00, 1.00, 0.19)),
    "CL": (1.00, (0.12, 0.94, 0.12)),
    "BR": (1.15, (0.65, 0.16, 0.16)),
    "I": (1.40, (0.58, 0.00, 0.58)),
    "FE": (1.25, (0.88, 0.40, 0.20)),
}
DEFAULT_ELEMENT = (0.8, (0.8, 0.4, 0.8))


@dataclass
class Molecule:
    positions: np.ndarray  # (A, 3)
    elements: list  # (A,) symbols
    bonds: np.ndarray  # (B, 2) atom indices


def parse_molfile(text: str) -> Molecule:
    """Parse a V2000 molfile (the chemistry `.sdf` the reference's mol
    example consumes)."""
    lines = text.splitlines()
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])
    positions = np.zeros((n_atoms, 3), np.float32)
    elements = []
    for i in range(n_atoms):
        ln = lines[4 + i]
        positions[i] = [float(ln[0:10]), float(ln[10:20]), float(ln[20:30])]
        elements.append(ln[31:34].strip().upper())
    bonds = np.zeros((n_bonds, 2), np.int32)
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        bonds[i] = [int(ln[0:3]) - 1, int(ln[3:6]) - 1]
    return Molecule(positions, elements, bonds)


def bond_transform(a: np.ndarray, b: np.ndarray, radius: float) -> np.ndarray:
    """4x4 matrix placing a unit Z cylinder (z0=0, z1=1) from a to b —
    the NewTransformedCylinder construction."""
    d = b - a
    length = float(np.linalg.norm(d))
    z = d / max(length, 1e-12)
    up = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    c = float(np.dot(up, z))
    if np.linalg.norm(v) < 1e-8:
        rot = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (rot @ np.diag([radius, radius, length])).astype(np.float32)
    m[:3, 3] = a
    return m


def add_molecule(builder, mol: Molecule, atom_scale: float = 0.4,
                 bond_radius: float = 0.18, center: bool = True):
    """Add ball-and-stick geometry to a SceneBuilder."""
    pos = mol.positions.copy()
    if center:
        pos -= pos.mean(axis=0)
    bond_mat = glossy_material((0.85, 0.85, 0.85), 1.4, math.radians(20))
    for i, el in enumerate(mol.elements):
        radius, color = ELEMENTS.get(el, DEFAULT_ELEMENT)
        builder.add_sphere(pos[i], radius * atom_scale,
                           glossy_material(color, 1.4, math.radians(15)))
    for a, b in mol.bonds:
        # unit Z cylinder scaled to (bond_radius, bond_radius, length)
        t = bond_transform(pos[a], pos[b], bond_radius)
        builder.add_cylinder(1.0, 0.0, 1.0, bond_mat, transform=t)
    return builder


def benzene() -> Molecule:
    """Procedural benzene (C6H6) — an embedded test molecule so the mol
    pipeline runs without external assets."""
    pos = []
    elements = []
    bonds = []
    rc, rh = 1.39, 2.48
    for i in range(6):
        ang = i * math.pi / 3.0
        pos.append([rc * math.cos(ang), rc * math.sin(ang), 0.0])
        elements.append("C")
    for i in range(6):
        ang = i * math.pi / 3.0
        pos.append([rh * math.cos(ang), rh * math.sin(ang), 0.0])
        elements.append("H")
    for i in range(6):
        bonds.append([i, (i + 1) % 6])
        bonds.append([i, 6 + i])
    return Molecule(np.asarray(pos, np.float32), elements,
                    np.asarray(bonds, np.int32))


def caffeine_like() -> Molecule:
    """A fused-ring demo molecule (purine-scaffold-inspired layout, not a
    crystallographic structure) for a denser mol render."""
    b = benzene()
    # add a second ring sharing an edge
    extra = np.array(
        [[2.78, 0.8, 0.3], [3.6, -0.2, 0.1], [2.9, -1.4, -0.2]], np.float32
    )
    pos = np.concatenate([b.positions, extra])
    elements = b.elements + ["N", "C", "O"]
    bonds = np.concatenate(
        [b.bonds, np.array([[0, 12], [12, 13], [13, 14], [14, 1]], np.int32)]
    )
    return Molecule(pos, elements, bonds)
