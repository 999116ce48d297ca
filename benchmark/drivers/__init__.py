"""One driver per kind of traffic, named by a traffic file's ``driver``.

A driver's ``run(run)`` makes the cell's weights and inputs from the seed,
builds the port's entry, warms it, measures the window and checks the
answers against the reference; ``control(run, precision)`` gives the numbers
of the reference at a lower precision in the program's place.
"""
