"""Runtime of the port: checkpoint/restart supervision and straggler
detection."""
from .fault_tolerance import (StragglerMonitor, StragglerReport,
                              TrainingSupervisor)
