"""Training runtime of the port: the fault-tolerant driver (``driver``)
and int8 gradient compression with error feedback (``compression``)."""
