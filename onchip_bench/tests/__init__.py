"""CPU tests of the benchmark: the references against the port at small sizes,
the work counts, finding pieces by name, the imports, and the check's faults."""
