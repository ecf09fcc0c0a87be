"""Host-side robot I/O: the service bridges and the native controller
bindings (port of ``ealv_tpu/hw``). Importing it builds nothing."""
from .native import NativeControllers, build_native, ControlMode
from .bridge import RobotBridge, SyntheticBridge, NativeBridge
