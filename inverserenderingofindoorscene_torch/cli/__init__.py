"""The stage CLIs (``train_brdf``, ``train_light``) and their shared
plumbing (``common``)."""
