"""Stage composition: BRDF and lighting stacks and the serving chain."""
