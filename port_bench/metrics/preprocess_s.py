"""Seconds of the set-up's first solve in the preprocessor (the program,
its plans, the copies to the card and, for the fused loop, its capture):
``SolverSummary.preprocessor_time_in_seconds``."""


def read(records):
    return records["setup"]["preprocess_s"]
