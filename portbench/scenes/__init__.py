"""Scenes: what a mix's frames show.  A mix names its scene
(`"scene": "<name>"` in `traffic/<mix>.json`), and `traffic.make_inputs`
finds `scenes/<name>.py`, whose `make_inputs(mix, frame, gen, device)`
makes every input of a run from the seeded generator `gen`.  A new scene
is a new file here.  `render.py` holds the renderers they share.
"""
