// Flat structs-of-arrays graph exchanged across the C ABI.
//
// The reference's server deserializes into an object graph of virtual
// vertex/edge classes (reference remote/graph/GraphCpu.h:12-60,
// BaseEdgeCpu.h:10-46).  Here the native runtime keeps the same
// structs-of-arrays layout the JAX engine uses (toyslam_tpu/models/graph.py):
// dense pose/landmark arrays plus per-type edge arrays — one contiguous
// allocation each, trivially shareable with numpy via ctypes.
#pragma once

#include <cstdint>

extern "C" {

typedef struct TsGraph {
  // vertices (dense order; original wire ids preserved for re-encode)
  uint32_t n_poses;
  float* poses;        // [n_poses * 3]  (x, y, theta)
  uint32_t* pose_ids;  // [n_poses]      wire id per pose
  uint32_t n_landmarks;
  float* landmarks;    // [n_landmarks * 2]
  uint32_t* lm_ids;    // [n_landmarks]

  // odometry edges (wire edge type 0; measurement a 3x3 transform on the
  // wire, stored here as (x, y, theta); information diagonal-encoded, as on
  // the wire — reference python/remote/graph_to_bytes.py:16-20)
  uint32_t n_odom;
  uint32_t* odom_i;    // [n_odom] dense pose index
  uint32_t* odom_j;    // [n_odom]
  float* odom_meas;    // [n_odom * 3]
  float* odom_info;    // [n_odom * 3] information diagonal

  // landmark edges (wire edge type 1; (range, bearing) measurement)
  uint32_t n_lm_edges;
  uint32_t* lme_pose;  // [n_lm_edges] dense pose index
  uint32_t* lme_lm;    // [n_lm_edges] dense landmark index
  float* lme_meas;     // [n_lm_edges * 2]
  float* lme_info;     // [n_lm_edges * 2]

  // gauge-fixed vertices, as wire ids
  uint32_t n_fixed;
  uint32_t* fixed_ids;
} TsGraph;

TsGraph* ts_graph_alloc(uint32_t n_poses, uint32_t n_landmarks,
                        uint32_t n_odom, uint32_t n_lm_edges,
                        uint32_t n_fixed);
void ts_graph_free(TsGraph* g);

}  // extern "C"
