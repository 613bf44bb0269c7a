from .spec import (CONTACT_FRAMES, CONTACT_LEG_JOINTS, DEFAULT_JOINT_STATE,
                   EE_FRAME, JOINT_NAMES, NQ, NUM_ARM_JOINTS, NUM_BASE,
                   NUM_CONTACTS, NUM_JOINTS, NUM_LEG_JOINTS, RobotModel,
                   default_q, load_model)
