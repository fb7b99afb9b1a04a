"""Idealized world land mask (copy of cice_tpu/core/landmask.py), used by
the POP grid fixtures and by the file-less `displaced_pole` and `tripole`
grid formats: the production gx/tx grids ship as external files, so a
plausible continental mask is synthesized at true cell coordinates.
"""

from __future__ import annotations

import numpy as np


def continents_mask(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Crude continents (1=ocean, 0=land) evaluated at geographic
    coordinates `lat`/`lon` in degrees (lon normalized to [0, 360)).

    Features that matter for sea-ice dynamics: a nearly land-locked Arctic
    basin with two gateways, a circumpolar Southern Ocean with an Antarctic
    continent, and meridional barriers (Americas, Afro-Eurasia) so ice drift
    sees coastlines. Works on any curvilinear grid (displaced-pole/tripole)
    because it is a function of true coordinates, not indices.
    """
    lat = np.asarray(lat, np.float64)
    lon = np.mod(np.asarray(lon, np.float64), 360.0)
    ocean = np.ones(lat.shape)

    # Antarctica: land poleward of ~-72, wobbling with longitude; the cap
    # below -84 is always land so a displaced south pole never sits in ocean
    ant_edge = -72.0 + 3.0 * np.sin(np.deg2rad(lon) * 2.0)
    ocean[lat < ant_edge] = 0.0
    ocean[lat < -84.0] = 0.0

    # "Americas": meridional barrier around lon ~ 280-300, from 60S to 70N
    amer = (lon > 278.0) & (lon < 300.0) & (lat > -55.0) & (lat < 70.0)
    ocean[amer] = 0.0

    # "Afro-Eurasia": broad land mass lon ~ 0-130 between -30 and 72N
    afr = (lon < 130.0) & (lat > -30.0) & (lat < 72.0) & (lon >= 0.0)
    ocean[afr & (lon < 55.0)] = 0.0
    eur = (lon >= 55.0) & (lon < 130.0) & (lat > 5.0) & (lat < 75.0)
    ocean[eur] = 0.0

    # Greenland-ish blob (also hosts the displaced NH pole of the gx grids)
    grl = (lon > 310.0) & (lon < 335.0) & (lat > 60.0) & (lat < 82.0)
    ocean[grl] = 0.0

    # Bering-strait-like gap stays open (lon ~ 190, lat ~ 66): carve channel
    ber = (lon > 185.0) & (lon < 195.0) & (lat > 50.0)
    ocean[ber] = 1.0
    return ocean


def idealized_world_kmt(nx: int, ny: int, lat_min: float = -78.0,
                        lat_max: float = 87.0) -> np.ndarray:
    """Continents mask sampled on a regular lat-lon index grid, with the
    top and bottom rows closed."""
    lat = np.linspace(lat_min, lat_max, ny)[:, None] * np.ones((1, nx))
    lon = np.ones((ny, 1)) * ((np.arange(nx) + 0.5) / nx * 360.0)[None, :]
    ocean = continents_mask(lat, lon)
    ocean[0, :] = 0.0
    ocean[-1, :] = 0.0
    return ocean
