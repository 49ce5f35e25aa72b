// Kernel #4's instances at D = 512, compiled in parallel with the other
// widths and linked with csrc/dual_stack.cu (its C entry and its design).

#include "dual_stack.cuh"

extern "C" int vmr_dual_stack_512(VMR_DUAL_STACK_PART_ARGS) {
  return stack_width<512>(dtype, v, t, vm, tm, W, b, ln, xb, v_out, t_out, scratch, kv_scratch,
                         stat_scratch, B, Lv, Lt, H, s);
}
