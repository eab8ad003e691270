"""Distribution support of the port: heartbeats and straggler detection
(``fault_tolerance``)."""
