from .gait import (FLY, MAX_EVENTS, MODE_NAMES, STANCE, ModeSchedule,
                   contact_flags_at_time, contact_flags_from_mode,
                   mode_at_time, mode_from_contact_flags, mode_name_to_number,
                   mode_schedule_from_lists)
from .library import GAIT_LIBRARY, GaitSchedule, ModeSequenceTemplate
from .swing import SwingConfig, swing_z_reference
