"""The parts of the harness that every cell shares: discovery by name, the
traffic generator, the emulated store, the result record, the trace reader
and the yardsticks (peaks, counts, the controller's reference)."""
