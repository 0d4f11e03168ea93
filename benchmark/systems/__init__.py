"""Systems under test, one module per kind of configuration
(``configs/<name>.json`` names it under ``system``).

A module defines ``System(cfg, mix, seed, device, requests)``, whose
constructor is the set-up (weights from the seed, warm-up of the cell's
shapes), and whose methods are ``drive(t0, seconds, stop_at)`` (the window
and its drain), ``release()`` (free the program's state) and
``check(mode)`` (the comparison with the plain reference once the window
has closed).
"""
