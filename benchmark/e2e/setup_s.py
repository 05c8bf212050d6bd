"""setup_s: process start to the first timed request (imports, card
start-up, kernel builds, scenes, weights, warm-up), host clock, less the
seconds the plain reference took to calibrate the thresholds
(``Run.calibration_s``), which no change to the program can move."""


def read(run):
    return run.setup_s
