from .binding import get_lib, native_available
