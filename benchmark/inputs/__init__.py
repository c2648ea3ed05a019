"""Input builders of the benchmark's configurations, one module each,
named by the ``builder`` key of a configuration's file.  A builder gives
the fixed columns and, from a numpy Generator, one witness with its
publics, as {column name: (N,) uint64 array}; the harness lays the
columns out in the order of the setup's constPolsMap and cmPolsMap."""
