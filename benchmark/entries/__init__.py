"""The general generators: each traffic file names one of these modules
under ``entry`` and gives its parameters. An entry builds the cell's
program objects from the seed, warms them up, measures, and checks the
timed path's output against ``benchmark/reference``."""
