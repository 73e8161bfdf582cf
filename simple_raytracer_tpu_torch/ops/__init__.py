"""Device compute ops: math, RNG, intersection, BSDF, sky, tonemap, trace."""
