"""Numerics core: SG lighting math, camera rays, BRDF shading, scale solvers."""
